// The language-grounded contrastive loss with cosine distance, for Hopper
// (sm_90a): its per-row forward and its backward.
//
// Replaces no Pallas kernel: the JAX package leaves contrastive_language_loss
// (languagegroundedsemseg_tpu/losses/contrastive.py) to XLA, which fuses it.
// In eager PyTorch the loss gathers (N, S, D) copies of the negatives'
// anchors, normalises them and the features, multiplies and reduces, and
// autograd keeps (N, S, D) tensors for its backward: about a dozen passes
// over tensors of 4.9 GB each at the 34D pretraining cell's level-0 size.
// These two kernels are one autograd node (ops/contrastive.py) that keeps
// only per-row scalars.
//
// Contract (f: (N, D) f32 or bf16, row-major; labels: (N,) int32; neg:
// (N, S) int64 class ids; A: (C, D) f32 unit anchors; row_mask: (N,) f32 or
// none; ids clamped to [0, C)):
//
//   n = ||f||,  r = 1 / max(n, eps),  c_p = r f.A[label],
//   c_n = r f.(sum_s A[neg_s]) / S,  valid = label != ignore and mask > 0
//   pos = valid ? relu(1 - c_p - pos_thresh) : 0
//   negl = valid ? relu(neg_thresh - (1 - c_n)) : 0,  stat = [c_p, c_n, n]
//
// and, from the cotangents gp and gn of pos and negl, with
// wp = pos > 0 ? gp : 0 and wn = negl > 0 ? gn : 0 (relu's and the valid
// mask's gradient):
//
//   df = r (-wp A[label] + wn / S sum_s A[neg_s])
//        + [n >= eps] r^2 (wp c_p - wn c_n) f
//
// the gradient of 1 - f/max(||f||, eps) . a through the normalisation (the
// clamp passes no gradient below eps). df is written in f's type.
//
// What bounds it on this card: bytes. A row is ~3 operations a channel
// against 4 (forward) or 8 (backward) bytes of f and df; the anchor table
// (200 x 512 f32 in the 34D cell, 400 KB) stays in L1 and L2. So a warp
// owns a row at a time: its lanes stream the row's 16-byte vectors (8-byte
// for bf16) with evict-first loads, UNROLL vectors a lane in flight, read
// the label's and the negatives' anchor vectors through the read-only
// cache, and reduce three sums (||f||^2, f.A[label], f.sum_s A[neg_s])
// with a butterfly of shuffles, which gives every lane the same bits. A
// warp takes ROWS_PER_WARP consecutive rows. Every row's f is read and
// every row's df written, padding rows too, so the bytes moved are those
// the benchmark's bound counts. The order of every sum is a function of D
// alone: two launches give equal bits. No atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // a block: eight warps
constexpr int ROWS_PER_WARP = 8;  // consecutive rows a warp owns
constexpr int UNROLL = 4;         // vectors a lane loads before it adds
constexpr int MAX_S = 8;          // negatives a row
constexpr float EPS = 1e-12f;     // the normalisation's clamp

enum { F32 = 0, BF16 = 1 };

__device__ __forceinline__ int64_t clamp_id(int64_t v, int C) {
  return v < 0 ? 0 : (v >= C ? C - 1 : v);
}

// 4 consecutive values of f (16-byte aligned f32, 8-byte aligned bf16),
// streamed: read once, evicted first.
__device__ __forceinline__ float4 load_f4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_f4(const __nv_bfloat16* p) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(q.x << 16),
                     __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16),
                     __uint_as_float(q.y & 0xffff0000u));
}
__device__ __forceinline__ float load_f1(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_f1(const __nv_bfloat16* p) {
  const unsigned short u = __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

__device__ __forceinline__ void store_f4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store_f4(__nv_bfloat16* p, float4 v) {
  const uint32_t h0 = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
  const uint32_t h1 = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
  const uint32_t h2 = __bfloat16_as_ushort(__float2bfloat16_rn(v.z));
  const uint32_t h3 = __bfloat16_as_ushort(__float2bfloat16_rn(v.w));
  __stcs(reinterpret_cast<uint2*>(p), make_uint2(h0 | (h1 << 16), h2 | (h3 << 16)));
}
__device__ __forceinline__ void store_f1(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_f1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row's anchors: the label's and the S negatives' rows of A.
struct Anchors {
  const float* pos;
  const float* neg[MAX_S];
};

__device__ __forceinline__ Anchors row_anchors(const int* __restrict__ labels,
                                               const int64_t* __restrict__ neg,
                                               const float* __restrict__ A,
                                               int64_t r, int D, int S,
                                               int C) {
  Anchors a;
  a.pos = A + clamp_id(labels[r], C) * D;
#pragma unroll
  for (int s = 0; s < MAX_S; ++s)
    a.neg[s] = s < S ? A + clamp_id(neg[r * S + s], C) * D : a.pos;
  return a;
}

// sum_s A[neg_s][j .. j + 4), in s order.
__device__ __forceinline__ float4 neg_sum4(const Anchors& a, int S, int j) {
  float4 t = __ldg(reinterpret_cast<const float4*>(a.neg[0] + j));
#pragma unroll
  for (int s = 1; s < MAX_S; ++s) {
    if (s < S) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(a.neg[s] + j));
      t.x += q.x;
      t.y += q.y;
      t.z += q.z;
      t.w += q.w;
    }
  }
  return t;
}

__device__ __forceinline__ float neg_sum1(const Anchors& a, int S, int j) {
  float t = __ldg(a.neg[0] + j);
#pragma unroll
  for (int s = 1; s < MAX_S; ++s)
    if (s < S) t += __ldg(a.neg[s] + j);
  return t;
}

// Forward: per row pos, negl and stat = [c_p, c_n, n].
template <typename T>
__global__ void __launch_bounds__(THREADS) contrast_fwd_kernel(
    const T* __restrict__ f, const int* __restrict__ labels,
    const float* __restrict__ row_mask, const int64_t* __restrict__ neg,
    const float* __restrict__ A, float* __restrict__ pos,
    float* __restrict__ negl, float* __restrict__ stat, int64_t rows, int D,
    int S, int C, int ignore, float pos_thresh, float neg_thresh) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t lo = warp * ROWS_PER_WARP;
  const int64_t hi = rows < lo + ROWS_PER_WARP ? rows : lo + ROWS_PER_WARP;
  const bool vec = D % 4 == 0;
  for (int64_t r = lo; r < hi; ++r) {
    const Anchors a = row_anchors(labels, neg, A, r, D, S, C);
    const T* fr = f + r * D;
    float ff = 0.f, dp = 0.f, dn = 0.f;
    if (vec) {
      const int nv = D / 4;
      for (int j0 = lane; j0 < nv; j0 += 32 * UNROLL) {
        float4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + 32 * u;
          v[u] = j < nv ? load_f4(fr + 4 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + 32 * u;
          if (j < nv) {
            const float4 p = __ldg(reinterpret_cast<const float4*>(a.pos + 4 * j));
            ff += dot4(v[u], v[u]);
            dp += dot4(v[u], p);
            dn += dot4(v[u], neg_sum4(a, S, 4 * j));
          }
        }
      }
    } else {
      for (int j0 = lane; j0 < D; j0 += 32 * UNROLL) {
        float v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + 32 * u;
          v[u] = j < D ? load_f1(fr + j) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + 32 * u;
          if (j < D) {
            ff += v[u] * v[u];
            dp += v[u] * __ldg(a.pos + j);
            dn += v[u] * neg_sum1(a, S, j);
          }
        }
      }
    }
    ff = warp_sum(ff);
    dp = warp_sum(dp);
    dn = warp_sum(dn);
    if (lane == 0) {
      const float n = sqrtf(ff);
      const float rinv = 1.f / fmaxf(n, EPS);
      const float cp = dp * rinv;
      const float cn = dn * rinv / (float)S;
      const bool valid =
          labels[r] != ignore && (row_mask == nullptr || row_mask[r] > 0.f);
      pos[r] = valid ? fmaxf(1.f - cp - pos_thresh, 0.f) : 0.f;
      negl[r] = valid ? fmaxf(neg_thresh - (1.f - cn), 0.f) : 0.f;
      stat[3 * r] = cp;
      stat[3 * r + 1] = cn;
      stat[3 * r + 2] = n;
    }
  }
}

// Backward: df from the cotangents of pos and negl.
template <typename T>
__global__ void __launch_bounds__(THREADS) contrast_bwd_kernel(
    const T* __restrict__ f, const int* __restrict__ labels,
    const int64_t* __restrict__ neg, const float* __restrict__ A,
    const float* __restrict__ stat, const float* __restrict__ pos,
    const float* __restrict__ negl, const float* __restrict__ gp,
    const float* __restrict__ gn, T* __restrict__ df, int64_t rows, int D,
    int S, int C) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t lo = warp * ROWS_PER_WARP;
  const int64_t hi = rows < lo + ROWS_PER_WARP ? rows : lo + ROWS_PER_WARP;
  const bool vec = D % 4 == 0;
  for (int64_t r = lo; r < hi; ++r) {
    const Anchors a = row_anchors(labels, neg, A, r, D, S, C);
    const float cp = stat[3 * r], cn = stat[3 * r + 1], n = stat[3 * r + 2];
    const float wp = pos[r] > 0.f ? gp[r] : 0.f;
    const float wn = negl[r] > 0.f ? gn[r] : 0.f;
    const float rinv = 1.f / fmaxf(n, EPS);
    const float alpha = -wp * rinv;
    const float beta = wn * rinv / (float)S;
    const float gamma = n >= EPS ? (wp * cp - wn * cn) * rinv * rinv : 0.f;
    const T* fr = f + r * D;
    T* dr = df + r * D;
    if (vec) {
      const int nv = D / 4;
      for (int j0 = lane; j0 < nv; j0 += 32 * UNROLL) {
        float4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + 32 * u;
          v[u] = j < nv ? load_f4(fr + 4 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + 32 * u;
          if (j < nv) {
            const float4 p = __ldg(reinterpret_cast<const float4*>(a.pos + 4 * j));
            const float4 q = neg_sum4(a, S, 4 * j);
            store_f4(dr + 4 * j,
                     make_float4(alpha * p.x + beta * q.x + gamma * v[u].x,
                                 alpha * p.y + beta * q.y + gamma * v[u].y,
                                 alpha * p.z + beta * q.z + gamma * v[u].z,
                                 alpha * p.w + beta * q.w + gamma * v[u].w));
          }
        }
      }
    } else {
      for (int j0 = lane; j0 < D; j0 += 32 * UNROLL) {
        float v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + 32 * u;
          v[u] = j < D ? load_f1(fr + j) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + 32 * u;
          if (j < D)
            store_f1(dr + j, alpha * __ldg(a.pos + j) + beta * neg_sum1(a, S, j) +
                                 gamma * v[u]);
        }
      }
    }
  }
}

// The launch plan: whole blocks of THREADS threads covering the rows,
// ROWS_PER_WARP a warp.
constexpr int ROWS_PER_BLOCK = THREADS / 32 * ROWS_PER_WARP;

int blocks_for(int rows) {
  return static_cast<int>(((int64_t)rows + ROWS_PER_BLOCK - 1) /
                          ROWS_PER_BLOCK);
}

bool shape_ok(int rows, int D, int S, int C) {
  return rows > 0 && D > 0 && S > 0 && S <= MAX_S && C > 1;
}

int done() { return static_cast<int>(cudaGetLastError()); }

constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers,
// f and df 16-byte aligned; dtype codes 0 (f32) and 1 (bf16); row_mask may
// be null. Each launches blocks_for(rows) blocks and returns
// cudaErrorInvalidValue for a shape or type it does not take, else the
// launch's CUDA error.

// pos, negl: (rows,) f32; stat: (rows, 3) f32.
extern "C" int lgs_contrast_fwd(const void* f, const void* labels,
                                const void* row_mask, const void* neg,
                                const void* anchors, void* pos, void* negl,
                                void* stat, int rows, int D, int S, int C,
                                int dtype, int ignore, float pos_thresh,
                                float neg_thresh, void* stream) {
  if (!shape_ok(rows, D, S, C)) return BAD;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LGS_CONTRAST_FWD(T)                                                  \
  contrast_fwd_kernel<T><<<blocks_for(rows), THREADS, 0, st>>>(              \
      static_cast<const T*>(f), static_cast<const int*>(labels),             \
      static_cast<const float*>(row_mask), static_cast<const int64_t*>(neg), \
      static_cast<const float*>(anchors), static_cast<float*>(pos),          \
      static_cast<float*>(negl), static_cast<float*>(stat), rows, D, S, C,   \
      ignore, pos_thresh, neg_thresh)
  if (dtype == F32)
    LGS_CONTRAST_FWD(float);
  else if (dtype == BF16)
    LGS_CONTRAST_FWD(__nv_bfloat16);
  else
    return BAD;
#undef LGS_CONTRAST_FWD
  return done();
}

// gp, gn: (rows,) f32; df: (rows, D) of f's type.
extern "C" int lgs_contrast_bwd(const void* f, const void* labels,
                                const void* neg, const void* anchors,
                                const void* stat, const void* pos,
                                const void* negl, const void* gp,
                                const void* gn, void* df, int rows, int D,
                                int S, int C, int dtype, void* stream) {
  if (!shape_ok(rows, D, S, C)) return BAD;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LGS_CONTRAST_BWD(T)                                                  \
  contrast_bwd_kernel<T><<<blocks_for(rows), THREADS, 0, st>>>(              \
      static_cast<const T*>(f), static_cast<const int*>(labels),             \
      static_cast<const int64_t*>(neg), static_cast<const float*>(anchors),  \
      static_cast<const float*>(stat), static_cast<const float*>(pos),       \
      static_cast<const float*>(negl), static_cast<const float*>(gp),        \
      static_cast<const float*>(gn), static_cast<T*>(df), rows, D, S, C)
  if (dtype == F32)
    LGS_CONTRAST_BWD(float);
  else if (dtype == BF16)
    LGS_CONTRAST_BWD(__nv_bfloat16);
  else
    return BAD;
#undef LGS_CONTRAST_BWD
  return done();
}

// The launch of either kernel at `rows` rows, for the wrapper to report:
// plan = {blocks, THREADS, ROWS_PER_WARP, blocks an SM holds of the f32
// forward and of the f32 backward}.
extern "C" int lgs_contrast_plan(int rows, int* plan) {
  if (rows <= 0) return BAD;
  int fwd_per_sm = 0, bwd_per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fwd_per_sm, contrast_fwd_kernel<float>, THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &bwd_per_sm, contrast_bwd_kernel<float>, THREADS, 0);
  const int vals[5] = {blocks_for(rows), THREADS, ROWS_PER_WARP, fwd_per_sm,
                       bwd_per_sm};
  for (int i = 0; i < 5; ++i) plan[i] = vals[i];
  return static_cast<int>(err);
}
