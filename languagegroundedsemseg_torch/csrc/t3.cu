// The selector convs' bf16 masked-shift table T3, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds T3 from XLA ops
// (languagegroundedsemseg_tpu/ops/msconv.py `_t3`), which fuse. In eager
// PyTorch `_t3(x.to(bfloat16), mp, mn, mc)[:-1]` is a cast, two rolls, three
// mask casts and broadcast multiplies and two cats: about 50 bytes moved per
// (row, channel) of x, where this kernel moves 10 from f32 x (6 from bf16
// x). Every selector conv (ops/onehot_conv.py) builds it in its forward, its
// dX and its dW.
//
// Contract (x: (cap, c) f32 or bf16, row-major; mp, mn, mc: (cap,) uint8;
// T: (cap, 3c) bf16, row-major): row r of T is
//
//   [ bf16(x[(r-1) mod cap]) * mp[r] | bf16(x[r]) * mc[r] |
//     bf16(x[(r+1) mod cap]) * mn[r] ]
//
// bf16() rounds to nearest even (Tensor.to(torch.bfloat16) on the card), and
// each product is taken in f32 from the bf16 value and the mask and rounded
// to bf16 again, as the eager bf16 multiply does: so signed zeros, an
// infinity times 0 and NaNs come out as the eager expression's. The
// wraparound is torch.roll's. No guard row: the callers drop it.
//
// What bounds it: bytes (a few operations a byte, far below the card's
// operations-per-byte line). A thread owns one vector of channels (8, as
// 16-byte loads and stores, where c is a multiple of 8; else 1) over a run
// of consecutive rows and walks it, holding the previous, current and next
// rows of x in registers, UNROLL rows loaded ahead with their masks: each x
// row is read from device memory once and serves its own row and both
// neighbours' (a run's two halo rows come again through L1/L2 from the
// neighbouring runs), and each row of T is written once. No shared memory,
// no atomics: every element of T is written by one thread, so two launches
// give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // a block
constexpr int VEC = 8;             // channels a thread holds where c % VEC == 0
constexpr int UNROLL = 4;          // rows of x loaded ahead
constexpr int MAX_RUN = 64;        // rows a thread walks, at most
constexpr int MAX_C = 8192;        // widths the plan covers
// the runs shrink (halving from MAX_RUN) until the launch has at least this
// many threads: four waves of 2,048 threads on each of an H100 SXM's 132 SMs
constexpr int64_t MIN_THREADS = 132LL * 2048 * 4;

enum { F32 = 0, BF16 = 1 };

// W bf16 values of one row, as bit patterns.
template <int W>
struct Bits;
template <>
struct Bits<VEC> {
  uint4 v;
};
template <>
struct Bits<1> {
  unsigned short v;
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// a row's vector of x, rounded to bf16 (f32 x) or as it is (bf16 x)
__device__ __forceinline__ Bits<VEC> load(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return {make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                     pack2(b.z, b.w))};
}
__device__ __forceinline__ Bits<VEC> load(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ Bits<1> load1(const float* p) {
  return {__bfloat16_as_ushort(__float2bfloat16_rn(__ldg(p)))};
}
__device__ __forceinline__ Bits<1> load1(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const unsigned short*>(p))};
}
template <int W, typename T>
__device__ __forceinline__ Bits<W> load_row(const T* p) {
  if constexpr (W == VEC)
    return load(p);
  else
    return load1(p);
}

// two bf16 times the mask, in f32, rounded to bf16
__device__ __forceinline__ uint32_t mul2(uint32_t h2, float m) {
  return pack2(__uint_as_float(h2 << 16) * m,
               __uint_as_float(h2 & 0xffff0000u) * m);
}

template <int W>
__device__ __forceinline__ void store_masked(__nv_bfloat16* p, Bits<W> b,
                                             float m) {
  if constexpr (W == VEC) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(mul2(b.v.x, m), mul2(b.v.y, m), mul2(b.v.z, m),
                   mul2(b.v.w, m));
  } else {
    const float f = __uint_as_float(static_cast<uint32_t>(b.v) << 16) * m;
    *reinterpret_cast<unsigned short*>(p) =
        __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
}

// One thread: channels [v W, v W + W) of rows [r0, r0 + run) of T.
template <int W, typename T>
__global__ void __launch_bounds__(THREADS)
    t3_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mp,
              const uint8_t* __restrict__ mn, const uint8_t* __restrict__ mc,
              __nv_bfloat16* __restrict__ out, int64_t cap, int vecs,
              int run) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t j = item / vecs;
  const int v = static_cast<int>(item - j * vecs);
  const int64_t r0 = j * run;
  if (r0 >= cap) return;
  const int64_t r1 = r0 + run < cap ? r0 + run : cap;
  const int64_t c = static_cast<int64_t>(vecs) * W;
  const T* xv = x + static_cast<int64_t>(v) * W;
  __nv_bfloat16* o = out + r0 * 3 * c + static_cast<int64_t>(v) * W;
  Bits<W> prev = load_row<W>(xv + (r0 == 0 ? cap - 1 : r0 - 1) * c);
  Bits<W> cur = load_row<W>(xv + r0 * c);
  for (int64_t r = r0; r < r1; r += UNROLL) {
    Bits<W> next[UNROLL];
    float fp[UNROLL], fc[UNROLL], fn[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t row = r + u;
      if (row < r1) {
        next[u] = load_row<W>(xv + (row + 1 == cap ? 0 : row + 1) * c);
        fp[u] = __ldg(mp + row);
        fc[u] = __ldg(mc + row);
        fn[u] = __ldg(mn + row);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u < r1) {
        store_masked<W>(o, prev, fp[u]);
        store_masked<W>(o + c, cur, fc[u]);
        store_masked<W>(o + 2 * c, next[u], fn[u]);
        o += 3 * c;
        prev = cur;
        cur = next[u];
      }
    }
  }
}

// The launch plan, a function of (rows, c, dtype): the vector width, the
// vectors a row, the rows a thread walks and the blocks. False for what the
// kernel does not take.
struct Plan {
  int vec, vecs, run, blocks;
};

bool make_plan(int rows, int c, int dtype, Plan* p) {
  if (rows < 1 || c < 1 || c > MAX_C || (dtype != F32 && dtype != BF16))
    return false;
  p->vec = c % VEC == 0 ? VEC : 1;
  p->vecs = c / p->vec;
  p->run = MAX_RUN;
  while (p->run > 1 &&
         (static_cast<int64_t>(rows) + p->run - 1) / p->run * p->vecs <
             MIN_THREADS)
    p->run /= 2;
  const int64_t items =
      (static_cast<int64_t>(rows) + p->run - 1) / p->run * p->vecs;
  p->blocks = static_cast<int>((items + THREADS - 1) / THREADS);
  return true;
}

template <typename T>
int launch(const void* x, const void* mp, const void* mn, const void* mc,
           void* out, int rows, const Plan& p, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const uint8_t* m[3] = {static_cast<const uint8_t*>(mp),
                         static_cast<const uint8_t*>(mn),
                         static_cast<const uint8_t*>(mc)};
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (p.vec == VEC)
    t3_kernel<VEC, T><<<p.blocks, THREADS, 0, st>>>(xt, m[0], m[1], m[2], o,
                                                     rows, p.vecs, p.run);
  else
    t3_kernel<1, T><<<p.blocks, THREADS, 0, st>>>(xt, m[0], m[1], m[2], o,
                                                   rows, p.vecs, p.run);
  return static_cast<int>(cudaGetLastError());
}

constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers,
// x and out 16-byte aligned; dtype codes 0 (f32) and 1 (bf16). lgs_t3 writes
// T (rows, 3c) from x (rows, c) and the masks; it returns
// cudaErrorInvalidValue for a shape or type it does not take, else the
// launch's CUDA error.
extern "C" int lgs_t3(const void* x, const void* mp, const void* mn,
                      const void* mc, void* out, int rows, int c, int dtype,
                      void* stream) {
  Plan p;
  if (!make_plan(rows, c, dtype, &p)) return BAD;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == F32
             ? launch<float>(x, mp, mn, mc, out, rows, p, st)
             : launch<__nv_bfloat16>(x, mp, mn, mc, out, rows, p, st);
}

// The launch lgs_t3 makes at these shapes, for the wrapper to report:
// plan = {channels a thread, vectors a row, rows a thread, blocks, THREADS,
// blocks an SM holds of the kernel that runs}.
extern "C" int lgs_t3_plan(int rows, int c, int dtype, int* plan) {
  Plan p;
  if (!make_plan(rows, c, dtype, &p)) return BAD;
  int per_sm = 0;
  cudaError_t err;
  if (dtype == F32)
    err = p.vec == VEC ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             &per_sm, t3_kernel<VEC, float>, THREADS, 0)
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             &per_sm, t3_kernel<1, float>, THREADS, 0);
  else
    err = p.vec == VEC
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, t3_kernel<VEC, __nv_bfloat16>, THREADS, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, t3_kernel<1, __nv_bfloat16>, THREADS, 0);
  const int vals[6] = {p.vec, p.vecs, p.run, p.blocks, THREADS, per_sm};
  for (int i = 0; i < 6; ++i) plan[i] = vals[i];
  return static_cast<int>(err);
}
