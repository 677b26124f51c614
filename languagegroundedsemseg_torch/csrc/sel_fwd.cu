// Selector forward of the stride-1 k3 sparse convs, for Hopper (sm_90a).
//
// Replaces: _sel_fwd_kernel in languagegroundedsemseg_tpu/ops/onehot_conv.py
// (launched by _run_sel_fwd). Contract, per output row o of tile t = o / tile:
//
//   out[o] = mc[o] * (P[o, 0:c] + sum_{c=1..8} [ws_{t,c} <= a_c(o) < ws_{t,c} + win]
//                                              * P[a_c(o), c*c_run:(c+1)*c_run])
//
// with P = T3 @ [W_center | W_col1..8] in bf16 (cap, 9*c_run), anchors int32
// (8, cap) whose guard is cap, window starts int32 (n_tiles*8,), tile-major.
// The window test is part of the function: anchors outside their window are
// served by the overflow COO outside the kernel, so adding them here would
// count them twice. The guard anchor cap always fails the test (starts are
// clamped to cap - win); the kernel also checks a < cap, so P's missing
// guard row is never read.
//
// What bounds it on this card: bytes. Per output row it reads the center
// block and up to 8 anchored blocks of c_run bf16 (about 9*c_run*2 bytes),
// 8 anchors and 8 window starts (about 64 bytes), and writes c_run f32.
// There is no arithmetic to speak of (8 adds per channel), far below the
// ~295 operations per byte where the H100 turns compute bound.
//
// The simple design: the TPU needed a one-hot matmul because it has no
// fast gather in its vector memory; here selection is a plain row gather.
// One block per (output tile, channel chunk); each thread owns 8 channels
// and moves them with 16-byte loads, so a warp reads whole 128-byte
// segments of a P row. Rows of a tile are spread over the block's y
// threads. The sum runs in the TPU kernel's order (center, then columns
// 1..8) in f32, so the result matches the reference bit for bit wherever
// the inputs do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;  // bf16 channels per 16-byte load

__device__ __forceinline__ void add_bf16x8(float* acc, const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    acc[2 * j] += f.x;
    acc[2 * j + 1] += f.y;
  }
}

__global__ void sel_fwd_kernel(const int32_t* __restrict__ wstart,
                               const int32_t* __restrict__ anchors,
                               const uint8_t* __restrict__ mc,
                               const __nv_bfloat16* __restrict__ pall,
                               float* __restrict__ out, int cap, int n_cols,
                               int c_run, int tile, int win) {
  const int t = blockIdx.x;
  const int vecs = c_run / kVec;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= vecs) return;
  const int64_t row_stride = (int64_t)(n_cols + 1) * c_run;
  const int32_t* ws_t = wstart + (int64_t)t * n_cols;
  for (int r = threadIdx.y; r < tile; r += blockDim.y) {
    const int o = t * tile + r;
    float acc[kVec];
    const uint4 c0 = *reinterpret_cast<const uint4*>(
        pall + (int64_t)o * row_stride + v * kVec);
    {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        acc[2 * j] = f.x;
        acc[2 * j + 1] = f.y;
      }
    }
    for (int c = 0; c < n_cols; ++c) {
      const int a = anchors[(int64_t)c * cap + o];
      const int ws = ws_t[c];
      if (a >= ws && a < ws + win && a < cap) {
        const uint4 p = *reinterpret_cast<const uint4*>(
            pall + (int64_t)a * row_stride + (int64_t)(c + 1) * c_run +
            v * kVec);
        add_bf16x8(acc, p);
      }
    }
    const float m = static_cast<float>(mc[o]);
    float4* dst = reinterpret_cast<float4*>(out + (int64_t)o * c_run + v * kVec);
    dst[0] = make_float4(acc[0] * m, acc[1] * m, acc[2] * m, acc[3] * m);
    dst[1] = make_float4(acc[4] * m, acc[5] * m, acc[6] * m, acc[7] * m);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// the launch goes on ``stream`` and nothing synchronises. Returns
// cudaGetLastError() after the launch.
extern "C" int lgs_sel_fwd(const void* wstart, const void* anchors,
                           const void* mc, const void* pall, void* out,
                           int cap, int n_cols, int c_run, int tile, int win,
                           void* stream) {
  const int vecs = c_run / kVec;
  const int bx = vecs < 32 ? vecs : 32;
  int by = 256 / bx;
  if (by > tile) by = tile;
  const dim3 block(bx, by);
  const dim3 grid(cap / tile, (vecs + bx - 1) / bx);
  sel_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wstart), static_cast<const int32_t*>(anchors),
      static_cast<const uint8_t*>(mc),
      static_cast<const __nv_bfloat16*>(pall), static_cast<float*>(out), cap,
      n_cols, c_run, tile, win);
  return static_cast<int>(cudaGetLastError());
}
