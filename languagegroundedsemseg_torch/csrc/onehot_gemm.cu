// Windowed row gather followed by an f32 projection GEMM, for Hopper
// (sm_90a).
//
// Replaces: `kernel` in build_fn, scripts/bench_onehot_pallas.py:31 (the
// single-column one-hot gather-GEMM microbenchmark). Contract, for output
// row r of tile t = r / tile, a = anchors[r], ws = wstart[t]:
//
//   out[r] = [ws <= a < ws + win] * f32(bf16(t3[a])) @ W
//
// with t3 f32 (n_rows, cw), W f32 (cw, c_out), anchors int32 (n,), wstart
// int32 (n / tile,), out f32 (n, c_out). An anchor outside [0, n_rows)
// counts as out of its window. Only the gathered t3 values are rounded to
// bf16 (the TPU's one-hot product rounds them); W stays f32 and products
// are summed in f32, so no tensor-core type fits: TF32 would round W.
//
// What bounds it on this card: at the script's shapes (n = 262,144, cw =
// 384, c_out = 96) it moves ~0.5 GB (t3 once, the f32 output) but does
// 2 * n * cw * c_out = 19.3 GFLOP of f32 work on the CUDA cores (67 TFLOP/s):
// operations-bound at ~0.29 ms.
//
// The TPU kernel DMAs a 2048-row window per tile into VMEM (3.1 MB) and
// selects rows with a (1024 x 2048) one-hot matmul: W multiply-adds for each
// useful one. Neither fits here. The simple design: a block owns 64 output
// rows and all c_out columns. It reads its rows' anchors once, then walks K
// in chunks of 32: each row's chunk of t3 is gathered with 16-byte loads
// (zeros out of window), rounded to bf16 on the way into shared memory, and
// the matching 32 rows of W are staged beside it. 128 threads each hold an
// 8-row x (c_out / 16)-column register tile of f32 sums (rows strided by 8,
// columns by 16, so the shared-memory reads are conflict-free). The next
// chunk is loaded into registers while the current one is multiplied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BK = 32;        // channels of t3 (rows of W) per step
constexpr int THREADS = 128;  // 8 row groups x 16 column groups
constexpr int RM = BM / 8;    // rows per thread
constexpr int PA = BK + 1;    // sA pitch (floats): conflict-free stores
constexpr int A_VECS = BM * BK / 4 / THREADS;  // 16-byte t3 loads per thread

struct Args {
  const int32_t* wstart;
  const int32_t* anchors;
  const float* t3;
  const float* w;
  float* out;
  int n, n_rows, cw, c_out, tile, win;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// CN = c_out / 16 columns per thread
template <int CN>
__global__ void __launch_bounds__(THREADS) onehot_gemm_kernel(Args a) {
  constexpr int NC = 16 * CN;  // c_out
  __shared__ float sA[BM][PA];
  __shared__ __align__(16) float sW[BK][NC];
  __shared__ int sSrc[BM];
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * BM;

  if (tid < BM) {
    const int64_t r = r0 + tid;
    int src = -1;
    if (r < a.n) {
      const int an = a.anchors[r];
      const int ws = a.wstart[r / a.tile];
      if (an >= ws && an < ws + a.win && an >= 0 && an < a.n_rows) src = an;
    }
    sSrc[tid] = src;
  }
  __syncthreads();

  // this thread's share of each chunk load: t3 as (row, 4 channels), W as
  // (row of W, 4 columns)
  int a_row[A_VECS], a_k[A_VECS], w_k[CN], w_c[CN];
  const float* a_src[A_VECS];
#pragma unroll
  for (int q = 0; q < A_VECS; ++q) {
    const int v = tid + q * THREADS;
    a_row[q] = v / (BK / 4);
    a_k[q] = (v % (BK / 4)) * 4;
    const int s = sSrc[a_row[q]];
    a_src[q] = s >= 0 ? a.t3 + (int64_t)s * a.cw : nullptr;
  }
#pragma unroll
  for (int q = 0; q < CN; ++q) {
    const int v = tid + q * THREADS;
    w_k[q] = v / (NC / 4);
    w_c[q] = (v % (NC / 4)) * 4;
  }

  float4 a_next[A_VECS], w_next[CN];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < A_VECS; ++q) {
      const int k = k0 + a_k[q];
      a_next[q] = (a_src[q] != nullptr && k < a.cw)
                      ? *reinterpret_cast<const float4*>(a_src[q] + k)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < CN; ++q) {
      const int k = k0 + w_k[q];
      w_next[q] = k < a.cw ? *reinterpret_cast<const float4*>(
                                 a.w + (int64_t)k * NC + w_c[q])
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  const int ty = tid / 16, tx = tid % 16;
  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < a.cw; k0 += BK) {
#pragma unroll
    for (int q = 0; q < A_VECS; ++q) {
      float* dst = &sA[a_row[q]][a_k[q]];
      dst[0] = bf16_round(a_next[q].x);
      dst[1] = bf16_round(a_next[q].y);
      dst[2] = bf16_round(a_next[q].z);
      dst[3] = bf16_round(a_next[q].w);
    }
#pragma unroll
    for (int q = 0; q < CN; ++q)
      *reinterpret_cast<float4*>(&sW[w_k[q]][w_c[q]]) = w_next[q];
    __syncthreads();
    if (k0 + BK < a.cw) load(k0 + BK);  // prefetch into registers
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float av[RM], wv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = sA[ty + 8 * i][k];
#pragma unroll
      for (int j = 0; j < CN; ++j) wv[j] = sW[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t r = r0 + ty + 8 * i;
    if (r >= a.n) continue;
#pragma unroll
    for (int j = 0; j < CN; ++j) a.out[r * NC + tx + 16 * j] = acc[i][j];
  }
}

template <int CN>
int launch(const Args& a, cudaStream_t s) {
  const int blocks = (a.n + BM - 1) / BM;
  onehot_gemm_kernel<CN><<<blocks, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// cw must be a multiple of 4 and c_out 16, 32 or 96, the widths built (the
// wrapper checks). The launch goes on ``stream`` and nothing synchronises.
// Returns the launch's CUDA error, or cudaErrorInvalidValue for a c_out the
// kernel was not built for.
extern "C" int lgs_onehot_gemm(const void* wstart, const void* anchors,
                               const void* t3, const void* w, void* out,
                               int n, int n_rows, int cw, int c_out, int tile,
                               int win, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const int32_t*>(wstart),
         static_cast<const int32_t*>(anchors),
         static_cast<const float*>(t3),
         static_cast<const float*>(w),
         static_cast<float*>(out),
         n, n_rows, cw, c_out, tile, win};
  switch (c_out) {
    case 16: return launch<1>(a, s);
    case 32: return launch<2>(a, s);
    case 96: return launch<6>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
