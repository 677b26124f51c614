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
// 384, c_out = 96) the full mode moves ~0.3 GB from device memory (t3 once
// in bf16, the anchors, the f32 output) and does up to 9 * 2 * cap * cw *
// c_out = 174 GFLOP on the bf16 tensor cores (989 TFLOP/s): operations-
// bound near 0.17 ms. A design that gathers each column's rows separately
// also moves 9 * cap * cw * 2 = 1.81 GB from L2 into shared memory, a
// second floor of ~0.36 ms at ~5 TB/s. The TPU kernel projects each whole
// 1536-row window and selects with one-hot matmuls because its windows sit
// in VMEM; a window of three groups is 3.5 MB, far above a Hopper block's
// 227 KB of shared memory.
//
// Design: a direct gather feeding the tensor cores through an asynchronous
// ring. A block owns BM = 256 output rows (16 warps: 8 along the rows x 2
// along c_out, each 32 rows x c_out / 2) and first resolves, for every
// column, which t3 row each output row reads, or none (sSrc). It then walks
// (column, 32-channel chunk) steps through a ring of four shared-memory
// stages filled with 16-byte cp.async.cg copies: the rows' chunks gathered
// through sSrc, the matching 32 rows of W[col] beside them; a miss, a
// channel past cw or a W row past cw takes the zero-fill form (src-size 0)
// and reads nothing. Three steps are in flight while one is multiplied,
// with one __syncthreads a step. A thread's copies are a pointer and a size
// per row, set once per column, plus an offset a step: the step loop does no
// division (its integer work cost as much as the copies, measured). Warps
// multiply with bf16 mma.sync m16n8k16 on ldmatrix fragments from padded
// rows (no bank conflicts), double-buffered across the k16 slices and
// across the barrier, into f32 registers that hold one column's product
// only. At a column's last chunk the product is rounded to bf16 (full,
// no_dma) and folded into the running sum, which lives in shared memory
// (BM x c_out f32, padded); each thread owns the same elements at every
// fold, so no barrier guards it. The last column's fold writes the output.
// A block reads each W chunk once for its 256 rows: 1,024 blocks x 9 x 384
// x 96 x 2 B = 0.68 GB of W from L2 at the script's shapes (twice that at
// 128 rows a block).
//
// Each mode changes one stage: no_sel the rows resolved, no_proj the
// multiply (it adds the gathered channels instead and stages no W), no_dma
// the gather (the ring's t3 stages zero-filled once, no anchors read, no
// t3 copies; W staging, the multiplies and the rounding still run). So the
// four modes' times split the cost into gather, projection and traffic.
//
// What bounds this design, from those modes at the script's shapes on an
// H100 SXM at 700 W (PERF.md §6): neither floor above. The gather alone
// (no_proj, 16 KB of rows a step) and the W staging with the multiplies
// (no_dma, 6 KB a step) each take ~0.7 us a step on an SM, whatever they
// move: the step's cadence (its copies, its barrier, the warps' issue) is
// the cost, and full overlaps the two only in part. Producer warps that
// feed the ring and signal mbarriers, so the multiplying warps never wait
// at a block-wide barrier, are the next step; wgmma only after that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 256;       // output rows per block
constexpr int BK = 32;        // channels per step
constexpr int KK = BK / 16;   // k16 slices a step
constexpr int STAGES = 4;     // shared-memory ring depth
constexpr int THREADS = 512;  // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_COLS = 16;
constexpr int PA = BK + 8;    // shared-memory pitches (bf16): +16 bytes keep
                              // ldmatrix rows off one bank
constexpr int A_VECS = BM * BK / 8 / THREADS;  // 16-byte t3 copies a thread
constexpr int A_ROW_STEP = THREADS / (BK / 8);  // rows between them
static_assert(A_VECS * THREADS * 8 == BM * BK, "t3 chunk split over threads");
static_assert(KK % 2 == 0, "fragments double-buffered over k16 slices");

enum Mode { FULL = 0, NO_DMA = 1, NO_SEL = 2, NO_PROJ = 3 };

// The warps' tiling of a block's BM x c_out output, c_out = 16 * NB: with NB
// even, 8 warps along the rows x 2 along c_out (32 x c_out / 2 a warp: 2 A
// and NB / 2 B fragment loads feed 2 * NB mma a k16 slice); else 16 x 1
// (16 x c_out a warp).
template <int NB>
struct Tiling {
  static constexpr int WN = NB % 2 == 0 ? 2 : 1;  // warps along c_out
  static constexpr int WM = BM / (WARPS / WN);    // rows a warp
  static constexpr int MI = WM / 16;              // m16 tiles a warp
  static constexpr int NBW = NB / WN;             // 16-column blocks a warp
  static constexpr int NTW = 2 * NBW;             // n8 tiles a warp
};

// Dynamic shared memory of a block at c_out = nc and n_cols columns: the
// ring (t3 and W stages), the running sum (BM x (nc + 8) f32: the pad puts
// a fold's rows on distinct banks) and the resolved rows (n_cols x BM
// int32). ops/onehot_ablation.py:variants_geometry keeps a copy.
constexpr int smem_bytes(int nc, int n_cols) {
  return STAGES * (BM * PA + BK * (nc + 8)) * 2 + BM * (nc + 8) * 4 +
         n_cols * BM * 4;
}
static_assert(smem_bytes(96, MAX_COLS) <= 232448, "227 KB a block");

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

// 16 bytes global -> shared, asynchronously, of which the first n come
// from src: n = 0 zero-fills the 16 bytes and reads nothing (src must
// still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* src,
                                           int n) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The t3 row that column col reads for output row o, or -1 (zeros).
template <int MODE>
__device__ __forceinline__ int source_row(const Args& a, int col, int64_t o) {
  if (o >= a.cap) return -1;
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

// The copies one thread issues into the ring, step after step in (column,
// chunk) order, with no division: its A_VECS rows' t3 pointers and copy
// sizes for the column being issued (resolved from sSrc at the column's
// first chunk; a miss copies 0 bytes from row 0) and its share of each W
// chunk.
template <int MODE, int NC>
struct Issuer {
  static constexpr int PW = NC + 8;
  static constexpr int W_VECS = BK * NC / 8;  // 16-byte W copies a step
  static constexpr int W_PER = (W_VECS + THREADS - 1) / THREADS;
  const __nv_bfloat16* row[A_VECS];
  int size[A_VECS];
  int col = 0, kc = 0;  // the next step to issue

  __device__ __forceinline__ void issue(const Args& a, const int* sSrc,
                                        __nv_bfloat16* sA, __nv_bfloat16* sW,
                                        int n_kc) {
    const int tid = threadIdx.x;
    const int kv = (tid % (BK / 8)) * 8;  // this thread's 8 channels
    const int r0 = tid / (BK / 8);        // ... and its first row
    const int k0 = kc * BK;
    if (MODE != NO_DMA) {
      if (kc == 0) {
#pragma unroll
        for (int q = 0; q < A_VECS; ++q) {
          const int src = sSrc[col * BM + r0 + q * A_ROW_STEP];
          row[q] = a.t3 + (int64_t)(src >= 0 ? src : 0) * a.cw + kv;
          size[q] = src >= 0 ? 16 : 0;
        }
      }
      const bool kin = k0 + kv < a.cw;  // false only in a ragged last chunk
#pragma unroll
      for (int q = 0; q < A_VECS; ++q)
        cp_async16(sA + (r0 + q * A_ROW_STEP) * PA + kv,
                   kin ? row[q] + k0 : a.t3, kin ? size[q] : 0);
    }
    if (MODE != NO_PROJ) {
      const __nv_bfloat16* wc = a.w + ((int64_t)col * a.cw + k0) * NC;
#pragma unroll
      for (int q = 0; q < W_PER; ++q) {
        const int v = tid + q * THREADS;
        if (W_VECS % THREADS == 0 || v < W_VECS) {
          const int kr = v / (NC / 8), n = (v % (NC / 8)) * 8;
          const bool ok = k0 + kr < a.cw;
          cp_async16(sW + kr * PW + n, ok ? wc + kr * NC + n : a.w,
                     ok ? 16 : 0);
        }
      }
    }
    if (++kc == n_kc) {
      kc = 0;
      ++col;
    }
  }
};

// NB = c_out / 16 blocks of 16 output columns
template <int MODE, int NB>
__global__ void __launch_bounds__(THREADS, 1) onehot_variants_kernel(Args a) {
  using T = Tiling<NB>;
  constexpr int NC = 16 * NB;       // c_out
  constexpr int PW = NC + 8;
  constexpr int PACC = NC + 8;      // f32 pitch of the running sum
  constexpr int STAGE_A = BM * PA;  // bf16 elements of a stage's t3 tile
  constexpr int STAGE_W = BK * PW;  // ... and of its W tile
  constexpr bool kRound = MODE == FULL || MODE == NO_DMA;
  extern __shared__ __align__(16) unsigned char smem[];
  // [STAGES][BM][PA] t3 tiles, [STAGES][BK][PW] W tiles, [BM][PACC] f32
  // running sum, [n_cols][BM] resolved rows
  __nv_bfloat16* const ring_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const ring_w = ring_a + STAGES * STAGE_A;
  float* const sAcc = reinterpret_cast<float*>(ring_w + STAGES * STAGE_W);
  int* const sSrc = reinterpret_cast<int*>(sAcc + BM * PACC);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * BM;

  if (MODE == NO_DMA) {
    // the gather's stand-in: every t3 stage zero once, nothing resolved
    const uint4 zero = make_uint4(0, 0, 0, 0);
    uint4* ra = reinterpret_cast<uint4*>(ring_a);
    for (int i = tid; i < STAGES * STAGE_A / 8; i += THREADS) ra[i] = zero;
  } else {
    for (int i = tid; i < a.n_cols * BM; i += THREADS)
      sSrc[i] = source_row<MODE>(a, i / BM, r0 + i % BM);
  }
  __syncthreads();

  const int n_kc = (a.cw + BK - 1) / BK;
  const int n_steps = a.n_cols * n_kc;
  Issuer<MODE, NC> is;

  // prologue: steps 0 .. STAGES - 2 in flight
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (is.col < a.n_cols)
      is.issue(a, sSrc, ring_a + st * STAGE_A, ring_w + st * STAGE_W, n_kc);
    cp_async_commit();
  }

  float cacc[T::MI][T::NTW][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int j = 0; j < T::NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[mi][j][e] = 0.f;

  // ldmatrix row addresses: lane L feeds row L % 8 of matrix L / 8
  const int lr = lane & 7, lj = lane >> 3;
  const int wm = (warp / T::WN) * T::WM;       // the warp's first row
  const int wn = (warp % T::WN) * (NC / T::WN);  // ... and first column
  const int a_r = lr + ((lj & 1) << 3), a_c = (lj >> 1) << 3;
  const int b_r = lr + ((lj & 1) << 3), b_c = (lj >> 1) << 3;
  const int gq = lane >> 2, tq = (lane & 3) * 2;

  // the column is complete: fold it into the running sum (this thread's
  // own elements, in column order), or at the last column write the output
  auto fold = [&](int col) {
    const bool first = col == 0, last = col == a.n_cols - 1;
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mi * 16 + gq + h * 8;
        const int64_t o = r0 + r;
#pragma unroll
        for (int j = 0; j < T::NTW; ++j) {
          const int c = wn + j * 8 + tq;
          float p0 = cacc[mi][j][2 * h], p1 = cacc[mi][j][2 * h + 1];
          if (kRound) {
            p0 = bf16_round(p0);
            p1 = bf16_round(p1);
          }
          float2* acc = reinterpret_cast<float2*>(sAcc + r * PACC + c);
          if (!first) {
            const float2 prev = *acc;
            p0 = prev.x + p0;
            p1 = prev.y + p1;
          }
          if (!last)
            *acc = make_float2(p0, p1);
          else if (o < a.cap)
            *reinterpret_cast<float2*>(a.out + o * NC + c) =
                make_float2(p0, p1);
          cacc[mi][j][2 * h] = cacc[mi][j][2 * h + 1] = 0.f;
        }
      }
  };

  // step s reads stage cur; the stage step s - 1 read (prev) is refilled
  // with step s + STAGES - 1; (col, kc) is step s's column and chunk
  int cur = 0, col = 0, kc = 0;
  auto next = [&]() {
    cur = cur == STAGES - 1 ? 0 : cur + 1;
    if (++kc == n_kc) {
      kc = 0;
      ++col;
    }
  };
  if (MODE == NO_PROJ) {
    for (int s = 0; s < n_steps; ++s, next()) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of step s landed
      __syncthreads();  // everyone's landed; everyone is done with s - 1
      const int prev = cur == 0 ? STAGES - 1 : cur - 1;
      if (is.col < a.n_cols)
        is.issue(a, sSrc, ring_a + prev * STAGE_A, ring_w + prev * STAGE_W,
                 n_kc);
      cp_async_commit();  // possibly empty: keeps the group count per step
      const int k0 = kc * BK;
      const __nv_bfloat16* sA = ring_a + cur * STAGE_A;
      // the first c_out gathered channels, where they fall in this chunk
#pragma unroll
      for (int j = 0; j < T::NTW; ++j) {
        const int c = wn + j * 8 + tq - k0;
        if (c < 0 || c >= BK) continue;
#pragma unroll
        for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
                sA + (wm + mi * 16 + gq + h * 8) * PA + c);
            cacc[mi][j][2 * h] += __low2float(v);
            cacc[mi][j][2 * h + 1] += __high2float(v);
          }
      }
      if (kc == n_kc - 1) fold(col);
    }
  } else {
    // fragments double-buffered over the k16 slices: slice ki + 1's are
    // loaded while slice ki multiplies, and the next step's first while
    // this step's last multiplies, right after the step's one barrier
    uint32_t af[2][T::MI][4], bf[2][T::NBW][4];
    auto load = [&](int buf, const __nv_bfloat16* sA,
                    const __nv_bfloat16* sW, int kk) {
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
        ldmatrix_x4(af[buf][mi], sA + (wm + mi * 16 + a_r) * PA + kk + a_c);
#pragma unroll
      for (int nb = 0; nb < T::NBW; ++nb)
        ldmatrix_x4_trans(bf[buf][nb],
                          sW + (kk + b_r) * PW + wn + nb * 16 + b_c);
    };
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(0, ring_a, ring_w, 0);
    for (int s = 0; s < n_steps; ++s, next()) {
      // refill the stage step s - 1 used (every warp finished reading it
      // before the previous step's barrier) with step s + STAGES - 1
      const int prev = cur == 0 ? STAGES - 1 : cur - 1;
      if (is.col < a.n_cols)
        is.issue(a, sSrc, ring_a + prev * STAGE_A, ring_w + prev * STAGE_W,
                 n_kc);
      cp_async_commit();  // possibly empty: keeps the group count per step
      const __nv_bfloat16* sA = ring_a + cur * STAGE_A;
      const __nv_bfloat16* sW = ring_w + cur * STAGE_W;
      const int nxt = cur == STAGES - 1 ? 0 : cur + 1;
#pragma unroll
      for (int ki = 0; ki < KK; ++ki) {
        if (ki < KK - 1) {
          load((ki + 1) & 1, sA, sW, (ki + 1) * 16);
        } else {
          cp_async_wait<STAGES - 2>();  // step s + 1 landed (this thread)
          __syncthreads();  // ... for everyone; step s's reads are done
          if (s + 1 < n_steps)
            load(0, ring_a + nxt * STAGE_A, ring_w + nxt * STAGE_W, 0);
        }
#pragma unroll
        for (int nb = 0; nb < T::NBW; ++nb)
#pragma unroll
          for (int mi = 0; mi < T::MI; ++mi) {
            mma_bf16(cacc[mi][2 * nb], af[ki & 1][mi], bf[ki & 1][nb][0],
                     bf[ki & 1][nb][1]);
            mma_bf16(cacc[mi][2 * nb + 1], af[ki & 1][mi], bf[ki & 1][nb][2],
                     bf[ki & 1][nb][3]);
          }
      }
      if (kc == n_kc - 1) fold(col);
    }
  }
  cp_async_wait<0>();
}

// Opt in to the block's dynamic shared memory (above the 48 KB default) at
// its largest column count, and to the largest shared-memory carveout.
// Set on every launch, so no instantiation and no device misses it.
template <int MODE, int NB>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      onehot_variants_kernel<MODE, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(16 * NB, MAX_COLS));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(onehot_variants_kernel<MODE, NB>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int MODE, int NB>
int launch(const Args& a, cudaStream_t s) {
  cudaError_t err = set_attributes<MODE, NB>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((a.cap + BM - 1) / BM);
  onehot_variants_kernel<MODE, NB>
      <<<blocks, THREADS, smem_bytes(16 * NB, a.n_cols), s>>>(a);
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

template <int NB>
cudaError_t occupancy(int* per_sm, int n_cols) {
  cudaError_t err = set_attributes<FULL, NB>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, onehot_variants_kernel<FULL, NB>, THREADS,
      smem_bytes(16 * NB, n_cols));
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers,
// t3 and W 16-byte aligned; cw must be a multiple of 8, c_out 16, 32 or 96
// (the widths built) and at most cw, and n_cols = 3 * n_groups at most 16
// (the wrapper checks). The launch goes on ``stream`` and nothing
// synchronises. Returns the first CUDA error of the set-up and the launch,
// or cudaErrorInvalidValue for a mode or c_out the kernel was not built for.
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
  if (a.n_cols <= 0 || a.n_cols > MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case FULL: return launch_mode<FULL>(a, s);
    case NO_DMA: return launch_mode<NO_DMA>(a, s);
    case NO_SEL: return launch_mode<NO_SEL>(a, s);
    case NO_PROJ: return launch_mode<NO_PROJ>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch geometry compiled in, for the wrapper to check its own copy
// against and for reports: cfg = {BM, BK, STAGES, THREADS, MAX_COLS,
// dynamic shared memory bytes a block at (c_out, n_cols), blocks an SM
// holds there (the full mode's occupancy, from the runtime)}. Returns a
// CUDA error code, or cudaErrorInvalidValue for a c_out not built or
// n_cols outside 1 .. MAX_COLS.
extern "C" int lgs_onehot_variants_config(int* cfg, int c_out, int n_cols) {
  if (n_cols <= 0 || n_cols > MAX_COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  cudaError_t err;
  switch (c_out) {
    case 16: err = occupancy<1>(&per_sm, n_cols); break;
    case 32: err = occupancy<2>(&per_sm, n_cols); break;
    case 96: err = occupancy<6>(&per_sm, n_cols); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vals[7] = {BM, BK, STAGES, THREADS, MAX_COLS,
                       smem_bytes(c_out, n_cols), per_sm};
  for (int i = 0; i < 7; ++i) cfg[i] = vals[i];
  return static_cast<int>(err);
}
