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
// clamped to cap - win); the kernel also checks 0 <= a < cap, so no row
// outside P is ever read.
//
// What bounds it on this card: bytes. Per output row it reads the center
// block and the in-window anchored blocks of c_run bf16 (3-4 of 8 on the
// main path), 8 anchors, and writes c_run f32. There is no arithmetic to
// speak of (8 adds per channel), far below the ~295 operations per byte
// where the H100 turns compute bound. The loads are gathers whose addresses
// depend on the anchors, so what a design has to beat is the latency of
// dependent loads, with enough of them in flight to cover the memory rate.
//
// Design. A block owns `rows` consecutive rows inside one tile (so it reads
// one set of n_cols window starts) and a chunk of the channels; the wrapper
// sizes both from the shapes alone (sel_geometry in ops/onehot_conv.py) so
// that every level of the network gives at least two blocks an SM. Two
// phases, one barrier:
//
//   1. Stage. The block's n_cols x rows anchors arrive as 16-byte loads
//      (each column's slice is contiguous), all in flight together; each
//      anchor is tested against its column's window start once and kept in
//      shared memory as the anchored P row, or -1 for a miss.
//   2. Sum. One thread per (row, 8-channel vector): it issues the center
//      load and the n_cols anchored 16-byte loads (zero for a miss) into
//      registers, all before the first add, then adds them in the TPU
//      kernel's order (center, then columns 1..8) in f32 and multiplies by
//      mc once. Consecutive threads take consecutive vectors of a row, so
//      P reads and out writes are coalesced row segments. n_cols == 8, the
//      only count the model gives, is unrolled; any other count takes the
//      same loads one column at a time.
//
// A miss adds +0.0, exactly as the plain version's where(hit, g, 0) does,
// and a block's split of rows or channels changes no sum's order: the result
// is bit-equal to the plain version and to a second launch. No atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // most threads a block
constexpr int MIN_BLOCKS = 4;  // blocks an SM holds: at most 64 registers a thread
constexpr int SMEM_LIMIT = 48 * 1024;  // static limit; no attribute call needed

// Dynamic shared memory of a launch: the resolved anchor row of every
// (column, row) of the block, int32, rounded up to 16 bytes.
__host__ __device__ constexpr int smem_bytes(int n_cols, int rows) {
  return (n_cols * rows * 4 + 15) / 16 * 16;
}

struct Args {
  const int32_t* wstart;
  const int32_t* anchors;
  const uint8_t* mc;
  const __nv_bfloat16* pall;
  float* out;
  int cap, n_cols, c_run, tile, win, rows, chunk;
};

// The anchored P row of anchor a under window start ws, or -1.
__device__ __forceinline__ int resolve(int a, int ws, int win, int cap) {
  return (a >= ws && a < ws + win && static_cast<unsigned>(a) <
                                         static_cast<unsigned>(cap))
             ? a
             : -1;
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// bf16 -> f32 is exact: the bf16 bits are the f32's upper half.
__device__ __forceinline__ void set8(float (&acc)[8], const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] = __uint_as_float(w[k] << 16);
    acc[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void add8(float (&acc)[8], const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] += __uint_as_float(w[k] << 16);
    acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
  }
}

// NCOLS: the anchored column count, unrolled; 0 reads it from Args.
template <int NCOLS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    sel_fwd_kernel(const Args p) {
  extern __shared__ __align__(16) int32_t s_row[];  // [n_cols][rows]
  const int n_cols = NCOLS > 0 ? NCOLS : p.n_cols;
  const int rows = p.rows;
  const int o0 = blockIdx.x * rows;
  const int t = o0 / p.tile;

  // 1. stage: the block's anchors, window-tested once, as P rows or -1
  const int quads = rows >> 2;
  for (int k = threadIdx.x; k < n_cols * quads; k += blockDim.x) {
    const int c = k / quads;
    const int j = (k - c * quads) << 2;
    const int4 a = __ldg(reinterpret_cast<const int4*>(
        p.anchors + (int64_t)c * p.cap + o0 + j));
    const int ws = __ldg(p.wstart + (int64_t)t * n_cols + c);
    *reinterpret_cast<int4*>(s_row + c * rows + j) =
        make_int4(resolve(a.x, ws, p.win, p.cap), resolve(a.y, ws, p.win, p.cap),
                  resolve(a.z, ws, p.win, p.cap), resolve(a.w, ws, p.win, p.cap));
  }
  __syncthreads();

  // 2. sum: one thread per (row, 8-channel vector) of this channel chunk
  const int ch0 = blockIdx.y * p.chunk;
  const int nv = min(p.chunk, p.c_run - ch0) >> 3;
  const int64_t stride = (int64_t)(n_cols + 1) * p.c_run;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int item = threadIdx.x; item < rows * nv; item += blockDim.x) {
    const int r = item / nv;
    const int o = o0 + r;
    const __nv_bfloat16* const col = p.pall + ch0 + ((item - r * nv) << 3);
    float acc[8];
    if constexpr (NCOLS > 0) {
      uint4 x[NCOLS + 1];
      x[0] = load16(col + (int64_t)o * stride);
#pragma unroll
      for (int c = 0; c < NCOLS; ++c) {
        const int a = s_row[c * rows + r];
        x[c + 1] = a >= 0 ? load16(col + (int64_t)a * stride + (c + 1) * p.c_run)
                          : zero;
      }
      set8(acc, x[0]);
#pragma unroll
      for (int c = 1; c <= NCOLS; ++c) add8(acc, x[c]);
    } else {
      set8(acc, load16(col + (int64_t)o * stride));
      for (int c = 0; c < n_cols; ++c) {
        const int a = s_row[c * rows + r];
        add8(acc, a >= 0 ? load16(col + (int64_t)a * stride + (c + 1) * p.c_run)
                         : zero);
      }
    }
    const float m = static_cast<float>(__ldg(p.mc + o));
    float4* const dst = reinterpret_cast<float4*>(
        p.out + (int64_t)o * p.c_run + ch0 + ((item - r * nv) << 3));
    dst[0] = make_float4(acc[0] * m, acc[1] * m, acc[2] * m, acc[3] * m);
    dst[1] = make_float4(acc[4] * m, acc[5] * m, acc[6] * m, acc[7] * m);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers,
// anchors, pall and out 16-byte aligned. The plan is the wrapper's
// (sel_geometry): ``rows`` rows a block (a multiple of 4 dividing tile),
// ``chunk`` channels a block (a multiple of 8), ``threads`` threads, and
// ``smem`` bytes, which must equal this file's smem_bytes(n_cols, rows); the
// grid is (cap / rows, ceil(c_run / chunk)). The launch goes on ``stream``
// and nothing synchronises. Returns cudaErrorInvalidValue for a plan this
// kernel does not take, else cudaGetLastError() after the launch.
extern "C" int lgs_sel_fwd(const void* wstart, const void* anchors,
                           const void* mc, const void* pall, void* out,
                           int cap, int n_cols, int c_run, int tile, int win,
                           int rows, int chunk, int threads, int smem,
                           void* stream) {
  if (cap <= 0 || n_cols <= 0 || c_run <= 0 || c_run % 8 || tile <= 0 ||
      cap % tile || win <= 0 || rows <= 0 || rows % 4 || tile % rows ||
      chunk <= 0 || chunk % 8 || threads < 32 || threads > THREADS ||
      threads % 32 || smem != smem_bytes(n_cols, rows) || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int32_t*>(wstart),
               static_cast<const int32_t*>(anchors),
               static_cast<const uint8_t*>(mc),
               static_cast<const __nv_bfloat16*>(pall),
               static_cast<float*>(out),
               cap, n_cols, c_run, tile, win, rows, chunk};
  const dim3 grid(cap / rows, (c_run + chunk - 1) / chunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cols == 8)
    sel_fwd_kernel<8><<<grid, threads, smem, s>>>(a);
  else
    sel_fwd_kernel<0><<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The constants compiled in, for the wrapper to check its own copy against
// and for reports: cfg = {THREADS, MIN_BLOCKS, SMEM_LIMIT,
// smem_bytes(n_cols, rows), blocks an SM holds for the kernel n_cols selects
// at ``threads`` threads and that shared memory (the occupancy the runtime
// computes)}. Returns a CUDA error code.
extern "C" int lgs_sel_fwd_config(int* cfg, int n_cols, int rows,
                                  int threads) {
  const int smem = smem_bytes(n_cols, rows);
  int per_sm = 0;
  const cudaError_t err =
      n_cols == 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, sel_fwd_kernel<8>, threads, smem)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, sel_fwd_kernel<0>, threads, smem);
  const int vals[5] = {THREADS, MIN_BLOCKS, SMEM_LIMIT, smem, per_sm};
  for (int i = 0; i < 5; ++i) cfg[i] = vals[i];
  return static_cast<int>(err);
}
