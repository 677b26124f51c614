// The nine-column gather-GEMM of the one-hot cost ablation, in four modes,
// for Hopper (sm_90a).
//
// Replaces: `kernel` in main, scripts/bench_onehot_variants.py:35 (the
// ablation of a three-group one-hot conv's cost components). Contract, for
// output row o of tile t = o / tile and columns col = 0 .. n_cols - 1
// (n_cols = 3 * n_groups), with a = anchors[min(col, n_arows - 1), o],
// ws = wstart[t * n_groups + col / 3], hit = ws <= a < ws + win (and
// 0 <= a < n_rows):
//
//   full    (0): out[o] = sum_col hit * f32(bf16(t3[a] @ W[col]))
//   no_dma  (1): out[o] = 0   (the gather's loads replaced by a zero fill;
//                the projection, rounding and sums still run)
//   no_sel  (2): out[o] = sum_col t3[ws + o - t * tile] @ W[col]
//   no_proj (3): out[o] = sum_col hit * t3[a][:c_out]
//
// with t3 bf16 (n_rows, cw), W bf16 (n_cols, cw, c_out), anchors int32
// (n_arows, cap), wstart int32 (cap / tile * n_groups,), out f32 (cap,
// c_out). Columns are added in order in f32; each column's product is an
// f32 sum of exact bf16 products.
//
// What bounds it on this card: at the script's shapes (cap = 262,144, cw =
// 384, c_out = 96) the full mode moves ~0.3 GB (t3 once in bf16, the
// anchors, the f32 output) and does up to 9 * 2 * cap * cw * c_out =
// 174 GFLOP on the bf16 tensor cores (989 TFLOP/s): operations-bound near
// 0.18 ms. The TPU kernel projects each whole 1536-row window and selects
// with one-hot matmuls (1.5x those operations, and TILE x WIN selector
// multiply-adds) because its windows sit in VMEM; a window of three groups
// is 3.5 MB, far above a Hopper block's 227 KB of shared memory.
//
// The simple design: a direct gather feeding the tensor cores. A block owns
// 128 output rows; it first resolves, for every column, which t3 row each
// output row reads (or none), then walks (column, 64-channel chunk) steps:
// the rows' chunks are gathered into shared memory with 16-byte loads
// (zeros where none), the matching 64 rows of W[col] are staged beside
// them, and eight warps (16 rows x all c_out columns each) multiply with
// bf16 mma.sync m16n8k16 into f32 registers. At a column's last chunk its
// product is rounded to bf16 (full, no_dma) and added to the f32 output
// registers. The next step's loads are issued into registers while the
// current one is multiplied. Each mode changes one stage: no_sel the rows
// resolved, no_proj the multiply (it adds the gathered channels instead),
// no_dma the gather (a zero fill, no anchors read). So the four modes'
// times split the cost into gather, projection and memory traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output rows per block: 8 warps x 16 rows
constexpr int BK = 64;        // channels per step
constexpr int THREADS = 256;
constexpr int MAX_COLS = 16;
constexpr int PA = BK + 8;    // shared-memory pitches (bf16): +16 bytes keep
                              // ldmatrix rows off one bank
constexpr int A_VECS = BM * BK / 8 / THREADS;  // 16-byte t3 loads per thread

enum Mode { FULL = 0, NO_DMA = 1, NO_SEL = 2, NO_PROJ = 3 };

struct Args {
  const int32_t* wstart;
  const int32_t* anchors;
  const __nv_bfloat16* t3;
  const __nv_bfloat16* w;
  float* out;
  int cap, n_rows, cw, c_out, tile, win, n_groups, n_arows, n_cols;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The t3 row that column col reads for output row o, or -1 (zeros).
template <int MODE>
__device__ __forceinline__ int source_row(const Args& a, int col, int64_t o) {
  if (MODE == NO_DMA || o >= a.cap) return -1;
  const int64_t t = o / a.tile;
  const int ws = a.wstart[t * a.n_groups + col / 3];
  if (MODE == NO_SEL) {
    const int64_t r = ws + (o - t * a.tile);
    return (r >= 0 && r < a.n_rows) ? static_cast<int>(r) : -1;
  }
  const int row = col < a.n_arows - 1 ? col : a.n_arows - 1;
  const int an = a.anchors[(int64_t)row * a.cap + o];
  return (an >= ws && an < ws + a.win && an >= 0 && an < a.n_rows) ? an : -1;
}

// NB = c_out / 16 blocks of 16 output columns
template <int MODE, int NB>
__global__ void __launch_bounds__(THREADS) onehot_variants_kernel(Args a) {
  constexpr int NC = 16 * NB;       // c_out
  constexpr int NT = 2 * NB;        // n-tiles of 8 columns
  constexpr int PW = NC + 8;
  constexpr int W_VECS = BK * NC / 8;  // 16-byte W loads per step
  constexpr int W_PER = (W_VECS + THREADS - 1) / THREADS;
  __shared__ __align__(16) __nv_bfloat16 sA[BM][PA];
  __shared__ __align__(16) __nv_bfloat16 sW[BK][PW];
  __shared__ int sSrc[MAX_COLS][BM];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * BM;

  for (int i = tid; i < a.n_cols * BM; i += THREADS)
    sSrc[i / BM][i % BM] = source_row<MODE>(a, i / BM, r0 + i % BM);
  __syncthreads();

  const int n_kc = (a.cw + BK - 1) / BK;
  const int n_steps = a.n_cols * n_kc;

  int a_row[A_VECS], a_k[A_VECS];
#pragma unroll
  for (int q = 0; q < A_VECS; ++q) {
    const int v = tid + q * THREADS;
    a_row[q] = v / (BK / 8);
    a_k[q] = (v % (BK / 8)) * 8;
  }
  uint4 a_next[A_VECS], w_next[W_PER];
  // issue step s's loads into registers
  auto load = [&](int s) {
    const int col = s / n_kc, k0 = (s % n_kc) * BK;
#pragma unroll
    for (int q = 0; q < A_VECS; ++q) {
      a_next[q] = make_uint4(0, 0, 0, 0);
      if (MODE != NO_DMA) {
        const int src = sSrc[col][a_row[q]];
        const int k = k0 + a_k[q];
        if (src >= 0 && k < a.cw)
          a_next[q] = *reinterpret_cast<const uint4*>(
              a.t3 + (int64_t)src * a.cw + k);
      }
    }
    if (MODE == NO_PROJ) return;
    const __nv_bfloat16* wc = a.w + (int64_t)col * a.cw * NC;
#pragma unroll
    for (int q = 0; q < W_PER; ++q) {
      const int v = tid + q * THREADS;
      const int k = k0 + v / (NC / 8);
      w_next[q] = make_uint4(0, 0, 0, 0);
      if (v < W_VECS && k < a.cw)
        w_next[q] = *reinterpret_cast<const uint4*>(
            wc + (int64_t)k * NC + (v % (NC / 8)) * 8);
    }
  };

  float acc[NT][4], cacc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = cacc[j][e] = 0.f;

  // ldmatrix row addresses: lane L feeds row L % 8 of matrix L / 8
  const int lr = lane & 7, lj = lane >> 3;
  const int wm = warp * 16;
  const int a_r = wm + lr + ((lj & 1) << 3), a_c = (lj >> 1) << 3;
  const int b_r = lr + ((lj & 1) << 3), b_c = (lj >> 1) << 3;
  const int gq = lane >> 2, tq = (lane & 3) * 2;

  load(0);
  for (int s = 0; s < n_steps; ++s) {
    const int kc = s % n_kc, k0 = kc * BK;
#pragma unroll
    for (int q = 0; q < A_VECS; ++q)
      *reinterpret_cast<uint4*>(&sA[a_row[q]][a_k[q]]) = a_next[q];
    if (MODE != NO_PROJ) {
#pragma unroll
      for (int q = 0; q < W_PER; ++q) {
        const int v = tid + q * THREADS;
        if (v < W_VECS)
          *reinterpret_cast<uint4*>(&sW[v / (NC / 8)][(v % (NC / 8)) * 8]) =
              w_next[q];
      }
    }
    __syncthreads();
    if (s + 1 < n_steps) load(s + 1);  // prefetch into registers

    if (MODE == NO_PROJ) {
      // the first c_out gathered channels, where they fall in this chunk
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j * 8 + tq - k0;
        if (c < 0 || c >= BK) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 v =
              *reinterpret_cast<const __nv_bfloat162*>(&sA[wm + gq + h * 8][c]);
          cacc[j][2 * h] += __low2float(v);
          cacc[j][2 * h + 1] += __high2float(v);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, &sA[a_r][kk + a_c]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, &sW[kk + b_r][nb * 16 + b_c]);
          mma_bf16(cacc[2 * nb], af, bf[0], bf[1]);
          mma_bf16(cacc[2 * nb + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();

    if (kc == n_kc - 1) {  // the column is complete: fold it in
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = cacc[j][e];
          acc[j][e] += (MODE == FULL || MODE == NO_DMA) ? bf16_round(p) : p;
          cacc[j][e] = 0.f;
        }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t o = r0 + wm + gq + h * 8;
    if (o >= a.cap) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(a.out + o * NC + j * 8 + tq) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

template <int MODE, int NB>
int launch(const Args& a, cudaStream_t s) {
  const int blocks = static_cast<int>((a.cap + BM - 1) / BM);
  onehot_variants_kernel<MODE, NB><<<blocks, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(const Args& a, cudaStream_t s) {
  switch (a.c_out) {
    case 16: return launch<MODE, 1>(a, s);
    case 32: return launch<MODE, 2>(a, s);
    case 96: return launch<MODE, 6>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// cw must be a multiple of 8, c_out 16, 32 or 96 (the widths built) and at
// most cw, and n_cols = 3 * n_groups at most 16 (the wrapper checks). The
// launch goes on ``stream`` and nothing synchronises. Returns the launch's
// CUDA error, or cudaErrorInvalidValue for a mode or c_out the kernel was
// not built for.
extern "C" int lgs_onehot_variants(const void* wstart, const void* anchors,
                                   const void* t3, const void* w, void* out,
                                   int mode, int cap, int n_rows, int cw,
                                   int c_out, int tile, int win, int n_groups,
                                   int n_arows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const int32_t*>(wstart),
         static_cast<const int32_t*>(anchors),
         static_cast<const __nv_bfloat16*>(t3),
         static_cast<const __nv_bfloat16*>(w),
         static_cast<float*>(out),
         cap, n_rows, cw, c_out, tile, win, n_groups, n_arows, 3 * n_groups};
  if (a.n_cols > MAX_COLS) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case FULL: return launch_mode<FULL>(a, s);
    case NO_DMA: return launch_mode<NO_DMA>(a, s);
    case NO_SEL: return launch_mode<NO_SEL>(a, s);
    case NO_PROJ: return launch_mode<NO_PROJ>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
