// Masked batch norm of the port's sparse layers, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves SparseBatchNorm
// (languagegroundedsemseg_tpu/models/layers.py) to XLA, which fuses its
// elementwise work. In eager PyTorch the same norm is ~28 ops forward and
// ~28 backward, each a pass over the (rows, C) activation; these five
// kernels are one autograd node of six launches (ops/batch_norm.py).
//
// Contract (x: (rows, C) f32 or bf16, row-major; mask: (rows,) f32 0/1):
//
//   n = max(sum m, 1),  mu = sum m*x / n,  var = max(sum m*x^2 / n - mu^2, 0)
//   r = rsqrt(var + eps),  y = (x - mu) * (r * gamma) + beta   (every row)
//   dx = r*gamma * (g - m * (sum g + xhat * keep * sum g*xhat) / n)
//
// with xhat = (x - mu) * r and the backward's sums over EVERY row (a padding
// row's output depends on mu and var too); keep = 0 where the clamp of var
// at 0 was active (clamp's gradient), 1 elsewhere. In eval mode mu and var
// are the running statistics and dx = r*gamma * g. Statistics and sums are
// f32; y is written in its own type, dx in x's.
//
// What bounds it on this card: bytes. There are ~10 operations an element
// against 4-12 bytes. So each kernel streams its rows once with coalesced
// 4-channel vectors (16 bytes f32, 8 bytes bf16) and keeps every per-channel
// quantity in registers: the statistics read x on valid rows only (n*C*s),
// the apply reads x and writes y (2*rows*C*s), the backward's reduce reads g
// and x (2*rows*C*s), its apply g, and x on valid rows, and writes dx.
//
// Design: a block owns rpb consecutive rows and tx_n 4-channel vectors (a
// channel split, grid.y, where a row has more than 64 vectors); thread
// (tx, ty) walks rows ty, ty + ty_n, ... of the block, so a warp reads a
// contiguous stretch, UNROLL rows in flight before the first add. The two
// reductions write one f32 partial a block and channel; a separate combine
// sums the partials over the blocks in f64, in block order. The partition
// is a function of (rows, C) alone and every sum runs in a fixed order, so
// two launches give equal bits. No atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // at most, a block
constexpr int VEC = 4;        // channels a thread
constexpr int UNROLL = 4;     // rows a thread loads before it adds
constexpr int COMBINE_COLS = 32;
constexpr int COMBINE_WARPS = 8;

enum { F32 = 0, BF16 = 1 };
enum { EVAL = 0, TRAIN = 1, RECOMPUTE = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The 4 channels [c0, c0 + 4) of one row: one vector load where C is a
// multiple of 4 (then every row's vectors are aligned), else `n` scalar
// loads (n < 4 on the last vector of a row); channels past C read 0.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, int n, bool vec,
                                      float (&v)[VEC]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      v[0] = __uint_as_float(q.x << 16);
      v[1] = __uint_as_float(q.x & 0xffff0000u);
      v[2] = __uint_as_float(q.y << 16);
      v[3] = __uint_as_float(q.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = k < n ? to_f32(p[k]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ p, int n, bool vec,
                                       const float (&v)[VEC]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint32_t h[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        h[k] = __bfloat16_as_ushort(__float2bfloat16_rn(v[k]));
      *reinterpret_cast<uint2*>(p) = make_uint2(h[0] | (h[1] << 16),
                                                h[2] | (h[3] << 16));
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (k < n) p[k] = from_f32<T>(v[k]);
  }
}

// A thread's place: channel vector tx of the block's split, row lane ty of
// ty_n; its channels [c0, c0 + n) (n <= 0: past C, idle), the block's rows
// [lo, hi).
struct Place {
  int tx, ty, ty_n, c0, n;
  int64_t lo, hi;
};

__device__ __forceinline__ Place place(int64_t rows, int C, int rpb,
                                       int tx_n) {
  Place p;
  p.tx = threadIdx.x % tx_n;
  p.ty = threadIdx.x / tx_n;
  p.ty_n = blockDim.x / tx_n;
  p.c0 = (blockIdx.y * tx_n + p.tx) * VEC;
  p.n = min(VEC, C - p.c0);
  p.lo = (int64_t)blockIdx.x * rpb;
  p.hi = rows < p.lo + rpb ? rows : p.lo + rpb;
  return p;
}

// The block's two per-channel sums into its partial row: threads of lane
// ty = 0 add the ty_n lanes' values in lane order. Every thread calls it.
__device__ __forceinline__ void block_partial(const Place& p, int tx_n, int C,
                                              const float (&a)[VEC],
                                              const float (&b)[VEC],
                                              float* s_red, float* dst) {
  float* const s_a = s_red;
  float* const s_b = s_red + THREADS * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s_a[threadIdx.x * VEC + k] = a[k];
    s_b[threadIdx.x * VEC + k] = b[k];
  }
  __syncthreads();
  if (p.ty != 0 || p.n <= 0) return;
  float sa[VEC] = {0.f, 0.f, 0.f, 0.f}, sb[VEC] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < p.ty_n; ++j) {
    const int o = (j * tx_n + p.tx) * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sa[k] += s_a[o + k];
      sb[k] += s_b[o + k];
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (k < p.n) {
      dst[p.c0 + k] = sa[k];
      dst[C + p.c0 + k] = sb[k];
    }
}

// Forward statistics: partial (count, sum m*x, sum m*x^2) of the block's
// rows, written to part[blockIdx.x] = [count, sums (C), squares (C)]. Rows
// with m = 0 are not read.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bn_stats_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                    float* __restrict__ part, int64_t rows, int C, int rpb,
                    int tx_n) {
  __shared__ float s_red[2 * THREADS * VEC];
  __shared__ float s_cnt[THREADS];
  const Place p = place(rows, C, rpb, tx_n);
  const bool vec = C % VEC == 0;
  const int64_t step = p.ty_n;
  float s[VEC] = {0.f, 0.f, 0.f, 0.f}, q[VEC] = {0.f, 0.f, 0.f, 0.f};
  float cnt = 0.f;
  for (int64_t r = p.lo + p.ty; r < p.hi; r += step * UNROLL) {
    float m[UNROLL], v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t rr = r + u * step;
      m[u] = rr < p.hi ? mask[rr] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (m[u] != 0.f && p.n > 0) {
        load4(x + (r + u * step) * C + p.c0, p.n, vec, v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      cnt += m[u];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float mv = m[u] * v[u][k];
        s[k] += mv;
        q[k] += mv * v[u][k];
      }
    }
  }
  s_cnt[threadIdx.x] = cnt;
  float* const dst = part + (int64_t)blockIdx.x * (2 * C + 1);
  block_partial(p, tx_n, C, s, q, s_red, dst + 1);
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    float n = 0.f;
    for (int j = 0; j < p.ty_n; ++j) n += s_cnt[j * tx_n];
    dst[0] = n;
  }
}

// out[col] = sum over b of part[b, col], b in order, in f64: each warp sums
// a fixed stride of the blocks, then warp 0 adds the warps' sums in order.
__global__ void __launch_bounds__(COMBINE_COLS * COMBINE_WARPS)
    bn_combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int nb, int W) {
  __shared__ double s[COMBINE_WARPS][COMBINE_COLS];
  const int lane = threadIdx.x % COMBINE_COLS;
  const int w = threadIdx.x / COMBINE_COLS;
  const int col = blockIdx.x * COMBINE_COLS + lane;
  double acc = 0.0;
  if (col < W) {
#pragma unroll 8
    for (int b = w; b < nb; b += COMBINE_WARPS)
      acc += (double)part[(int64_t)b * W + col];
  }
  s[w][lane] = acc;
  __syncthreads();
  if (w != 0 || col >= W) return;
  double t = 0.0;
#pragma unroll
  for (int k = 0; k < COMBINE_WARPS; ++k) t += s[k][lane];
  out[col] = (float)t;
}

// y = (x - mu) * (r * gamma) + beta on every row. TRAIN / RECOMPUTE form mu,
// var and r from the combined sums `packed` (count, sums, squares), EVAL
// takes the running statistics. Block row 0 writes the node's saved
// statistics stat = [mu (C), r (C), keep (C), n] and, in TRAIN only, moves
// the running statistics: running = running * (1 - momentum) + momentum *
// batch, the variance unbiased (var * n / max(n - 1, 1)). Each op rounds
// as the eager version's does (no contraction into an FMA).
template <typename TX, typename TY>
__global__ void __launch_bounds__(THREADS)
    bn_apply_kernel(const TX* __restrict__ x, TY* __restrict__ y,
                    const float* __restrict__ packed, float* running_mean,
                    float* running_var, const float* __restrict__ weight,
                    const float* __restrict__ bias, float* __restrict__ stat,
                    int64_t rows, int C, int rpb, int tx_n, float eps,
                    float decay, float momentum, int mode) {
  const Place p = place(rows, C, rpb, tx_n);
  if (p.n <= 0) return;
  const bool train = mode != EVAL;
  const bool writer = blockIdx.x == 0 && p.ty == 0;
  const float n = train ? fmaxf(packed[0], 1.f) : 1.f;
  float mu[VEC], inv[VEC], beta[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int c = p.c0 + min(k, p.n - 1);  // lanes past C repeat the last
    float m, var, keep = 0.f;
    if (train) {
      m = __fdiv_rn(packed[1 + c], n);
      const float raw =
          __fsub_rn(__fdiv_rn(packed[1 + C + c], n), __fmul_rn(m, m));
      var = fmaxf(raw, 0.f);
      keep = raw >= 0.f ? 1.f : 0.f;
    } else {
      m = running_mean[c];
      var = running_var[c];
    }
    const float r = rsqrtf(__fadd_rn(var, eps));
    mu[k] = m;
    inv[k] = __fmul_rn(r, weight[c]);
    beta[k] = bias[c];
    if (writer && k < p.n) {
      stat[c] = m;
      stat[C + c] = r;
      stat[2 * C + c] = keep;
      if (mode == TRAIN) {
        const float unbiased =
            __fdiv_rn(__fmul_rn(var, n), fmaxf(__fsub_rn(n, 1.f), 1.f));
        running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], decay),
                                    __fmul_rn(momentum, m));
        running_var[c] = __fadd_rn(__fmul_rn(running_var[c], decay),
                                   __fmul_rn(momentum, unbiased));
      }
    }
  }
  if (writer && p.c0 == 0) stat[3 * C] = n;
  const bool vec = C % VEC == 0;
  const int64_t step = p.ty_n;
  for (int64_t r = p.lo + p.ty; r < p.hi; r += step * UNROLL) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t rr = r + u * step;
      if (rr < p.hi) load4(x + rr * C + p.c0, p.n, vec, v[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t rr = r + u * step;
      if (rr >= p.hi) continue;
      float o[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o[k] = __fadd_rn(__fmul_rn(__fsub_rn(v[u][k], mu[k]), inv[k]), beta[k]);
      store4(y + rr * C + p.c0, p.n, vec, o);
    }
  }
}

// Backward sums over every row of the block: sum g and sum g * xhat, to
// part[blockIdx.x] = [sum g (C), sum g*xhat (C)].
template <typename TX, typename TG>
__global__ void __launch_bounds__(THREADS)
    bn_bwd_reduce_kernel(const TG* __restrict__ g, const TX* __restrict__ x,
                         const float* __restrict__ stat,
                         float* __restrict__ part, int64_t rows, int C,
                         int rpb, int tx_n) {
  __shared__ float s_red[2 * THREADS * VEC];
  const Place p = place(rows, C, rpb, tx_n);
  const bool vec = C % VEC == 0;
  const int64_t step = p.ty_n;
  float sg[VEC] = {0.f, 0.f, 0.f, 0.f}, sgx[VEC] = {0.f, 0.f, 0.f, 0.f};
  if (p.n > 0) {
    float mu[VEC], r[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = p.c0 + min(k, p.n - 1);
      mu[k] = stat[c];
      r[k] = stat[C + c];
    }
    for (int64_t row = p.lo + p.ty; row < p.hi; row += step * UNROLL) {
      float gv[UNROLL][VEC], xv[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t rr = row + u * step;
        if (rr < p.hi) {
          load4(g + rr * C + p.c0, p.n, vec, gv[u]);
          load4(x + rr * C + p.c0, p.n, vec, xv[u]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) gv[u][k] = xv[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          sg[k] += gv[u][k];
          sgx[k] += gv[u][k] * __fmul_rn(__fsub_rn(xv[u][k], mu[k]), r[k]);
        }
    }
  }
  block_partial(p, tx_n, C, sg, sgx, s_red,
                part + (int64_t)blockIdx.x * (2 * C));
}

// dx = r*gamma * (g - m * (sum g + xhat * keep * sum g*xhat) / n) with the
// combined (and, under SyncBN, all-reduced) sums; train = 0 gives r*gamma*g.
// x is read on rows with m != 0 only.
template <typename TX, typename TG>
__global__ void __launch_bounds__(THREADS)
    bn_bwd_apply_kernel(const TG* __restrict__ g, const TX* __restrict__ x,
                        const float* __restrict__ mask,
                        const float* __restrict__ weight,
                        const float* __restrict__ stat,
                        const float* __restrict__ sums, TX* __restrict__ dx,
                        int64_t rows, int C, int rpb, int tx_n, int train) {
  const Place p = place(rows, C, rpb, tx_n);
  if (p.n <= 0) return;
  const float n = stat[3 * C];
  float mu[VEC], r[VEC], s[VEC], a[VEC], b[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int c = p.c0 + min(k, p.n - 1);
    mu[k] = stat[c];
    r[k] = stat[C + c];
    s[k] = __fmul_rn(r[k], weight[c]);
    a[k] = train ? __fdiv_rn(sums[c], n) : 0.f;
    b[k] = train ? __fdiv_rn(__fmul_rn(stat[2 * C + c], sums[C + c]), n) : 0.f;
  }
  const bool vec = C % VEC == 0;
  const int64_t step = p.ty_n;
  for (int64_t row = p.lo + p.ty; row < p.hi; row += step * UNROLL) {
    float m[UNROLL], gv[UNROLL][VEC], xv[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t rr = row + u * step;
      m[u] = (train && rr < p.hi) ? mask[rr] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t rr = row + u * step;
      if (rr < p.hi) load4(g + rr * C + p.c0, p.n, vec, gv[u]);
      if (m[u] != 0.f) load4(x + rr * C + p.c0, p.n, vec, xv[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t rr = row + u * step;
      if (rr >= p.hi) continue;
      float o[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float t = gv[u][k];
        if (m[u] != 0.f) {
          const float xh = __fmul_rn(__fsub_rn(xv[u][k], mu[k]), r[k]);
          t = __fsub_rn(t, __fmul_rn(m[u], __fadd_rn(a[k], __fmul_rn(xh, b[k]))));
        }
        o[k] = __fmul_rn(s[k], t);
      }
      store4(dx + rr * C + p.c0, p.n, vec, o);
    }
  }
}

// The launch plan the wrapper made (ops/batch_norm.py ``_bn_plan``):
// threads a whole number of row lanes of tx_n vectors, the splits covering
// C with none idle, grid.x the row blocks of rpb rows (one when rows is 0).
bool plan_ok(int64_t rows, int C, int rpb, int tx_n, int splits, int threads) {
  return rows >= 0 && C > 0 && rpb > 0 && tx_n > 0 && splits > 0 &&
         splits <= 65535 && threads >= tx_n && threads <= THREADS &&
         threads % tx_n == 0 && (int64_t)splits * tx_n * VEC >= C &&
         (int64_t)(splits - 1) * tx_n * VEC < C;
}

dim3 grid_of(int64_t rows, int rpb, int splits) {
  const int64_t nb = rows > 0 ? (rows + rpb - 1) / rpb : 1;
  return dim3((unsigned)nb, (unsigned)splits);
}

int done() { return static_cast<int>(cudaGetLastError()); }

constexpr int BAD = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers,
// x, y, g and dx 16-byte aligned where C is a multiple of 4; dtype codes 0
// (f32) and 1 (bf16). Each returns cudaErrorInvalidValue for a plan or type
// it does not take, else the launch's CUDA error.

// part: (row blocks, 2C + 1) f32.
extern "C" int lgs_bn_stats(const void* x, const void* mask, void* part,
                            int rows, int C, int dtype, int rpb, int tx_n,
                            int splits, int threads, void* stream) {
  if (!plan_ok(rows, C, rpb, tx_n, splits, threads)) return BAD;
  const dim3 grid = grid_of(rows, rpb, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* out = static_cast<float*>(part);
  if (dtype == F32)
    bn_stats_kernel<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(x), m, out, rows, C, rpb, tx_n);
  else if (dtype == BF16)
    bn_stats_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), m, out, rows, C, rpb, tx_n);
  else
    return BAD;
  return done();
}

// out (W,) = the sum of part's nb rows (nb, W), in row order.
extern "C" int lgs_bn_combine(const void* part, void* out, int nb, int W,
                              void* stream) {
  if (nb <= 0 || W <= 0) return BAD;
  bn_combine_kernel<<<(W + COMBINE_COLS - 1) / COMBINE_COLS,
                      COMBINE_COLS * COMBINE_WARPS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), nb, W);
  return done();
}

template <typename TX, typename TY>
void apply_launch(dim3 grid, int threads, cudaStream_t st, const void* x,
                  void* y, const void* packed, void* rm, void* rv,
                  const void* w, const void* b, void* stat, int rows, int C,
                  int rpb, int tx_n, float eps, float decay, float momentum,
                  int mode) {
  bn_apply_kernel<TX, TY><<<grid, threads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<TY*>(y),
      static_cast<const float*>(packed), static_cast<float*>(rm),
      static_cast<float*>(rv), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(stat), rows, C, rpb,
      tx_n, eps, decay, momentum, mode);
}

// y: (rows, C) of type ydtype; stat: (3C + 1,) f32; packed: (2C + 1,) f32,
// read in modes 1 (train) and 2 (train in a recompute: the running
// statistics stay); mode 0 (eval) reads running_mean / running_var instead.
extern "C" int lgs_bn_apply(const void* x, void* y, const void* packed,
                            void* running_mean, void* running_var,
                            const void* weight, const void* bias, void* stat,
                            int rows, int C, int xdtype, int ydtype, int rpb,
                            int tx_n, int splits, int threads, float eps,
                            float decay, float momentum, int mode,
                            void* stream) {
  if (!plan_ok(rows, C, rpb, tx_n, splits, threads) || mode < EVAL ||
      mode > RECOMPUTE)
    return BAD;
  const dim3 grid = grid_of(rows, rpb, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LGS_BN_APPLY(TX, TY)                                                  \
  apply_launch<TX, TY>(grid, threads, st, x, y, packed, running_mean,         \
                       running_var, weight, bias, stat, rows, C, rpb, tx_n,   \
                       eps, decay, momentum, mode)
  if (xdtype == F32 && ydtype == F32)
    LGS_BN_APPLY(float, float);
  else if (xdtype == F32 && ydtype == BF16)
    LGS_BN_APPLY(float, __nv_bfloat16);
  else if (xdtype == BF16 && ydtype == BF16)
    LGS_BN_APPLY(__nv_bfloat16, __nv_bfloat16);
  else if (xdtype == BF16 && ydtype == F32)
    LGS_BN_APPLY(__nv_bfloat16, float);
  else
    return BAD;
#undef LGS_BN_APPLY
  return done();
}

// part: (row blocks, 2C) f32.
extern "C" int lgs_bn_bwd_reduce(const void* g, const void* x,
                                 const void* stat, void* part, int rows,
                                 int C, int xdtype, int gdtype, int rpb,
                                 int tx_n, int splits, int threads,
                                 void* stream) {
  if (!plan_ok(rows, C, rpb, tx_n, splits, threads)) return BAD;
  const dim3 grid = grid_of(rows, rpb, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(stat);
  float* out = static_cast<float*>(part);
#define LGS_BN_REDUCE(TX, TG)                                                 \
  bn_bwd_reduce_kernel<TX, TG><<<grid, threads, 0, st>>>(                     \
      static_cast<const TG*>(g), static_cast<const TX*>(x), sp, out, rows, C, \
      rpb, tx_n)
  if (xdtype == F32 && gdtype == F32)
    LGS_BN_REDUCE(float, float);
  else if (xdtype == F32 && gdtype == BF16)
    LGS_BN_REDUCE(float, __nv_bfloat16);
  else if (xdtype == BF16 && gdtype == BF16)
    LGS_BN_REDUCE(__nv_bfloat16, __nv_bfloat16);
  else if (xdtype == BF16 && gdtype == F32)
    LGS_BN_REDUCE(__nv_bfloat16, float);
  else
    return BAD;
#undef LGS_BN_REDUCE
  return done();
}

// dx: (rows, C) of x's type; sums: (2C,) f32.
extern "C" int lgs_bn_bwd_apply(const void* g, const void* x,
                                const void* mask, const void* weight,
                                const void* stat, const void* sums, void* dx,
                                int rows, int C, int xdtype, int gdtype,
                                int rpb, int tx_n, int splits, int threads,
                                int train, void* stream) {
  if (!plan_ok(rows, C, rpb, tx_n, splits, threads)) return BAD;
  const dim3 grid = grid_of(rows, rpb, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const float* w = static_cast<const float*>(weight);
  const float* sp = static_cast<const float*>(stat);
  const float* su = static_cast<const float*>(sums);
#define LGS_BN_BWD(TX, TG)                                                    \
  bn_bwd_apply_kernel<TX, TG><<<grid, threads, 0, st>>>(                      \
      static_cast<const TG*>(g), static_cast<const TX*>(x), m, w, sp, su,     \
      static_cast<TX*>(dx), rows, C, rpb, tx_n, train)
  if (xdtype == F32 && gdtype == F32)
    LGS_BN_BWD(float, float);
  else if (xdtype == F32 && gdtype == BF16)
    LGS_BN_BWD(float, __nv_bfloat16);
  else if (xdtype == BF16 && gdtype == BF16)
    LGS_BN_BWD(__nv_bfloat16, __nv_bfloat16);
  else if (xdtype == BF16 && gdtype == F32)
    LGS_BN_BWD(__nv_bfloat16, float);
  else
    return BAD;
#undef LGS_BN_BWD
  return done();
}

// The constants compiled in, for the wrapper to check its own copy against
// and for reports: cfg = {THREADS, VEC, UNROLL, blocks an SM holds of the
// f32 statistics kernel and of the f32 apply kernel at `threads` threads}.
extern "C" int lgs_bn_config(int* cfg, int threads) {
  int stats_per_sm = 0, apply_per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &stats_per_sm, bn_stats_kernel<float>, threads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &apply_per_sm, bn_apply_kernel<float, float>, threads, 0);
  const int vals[5] = {THREADS, VEC, UNROLL, stats_per_sm, apply_per_sm};
  for (int i = 0; i < 5; ++i) cfg[i] = vals[i];
  return static_cast<int>(err);
}
