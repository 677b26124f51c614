// Fused dW of the stride-1 k3 selector convs' anchored columns, for Hopper
// (sm_90a).
//
// Replaces: _dw_kernel in languagegroundedsemseg_tpu/ops/onehot_conv.py
// (launched by _run_dw_fused). Contract, for column c and T3 row i of tile
// t = i / tile:
//
//   out[c] = sum_i T3[i]^T (x) G_c[i],   G_c[i] = g[o] if ws <= o < ws + win
//                                                 else 0,
//   o = inv_anchors[c, i],  ws = inv_wstart[t * n_cols + c]
//
// with T3 bf16 (cap, cw), g bf16 (cap, c_out), inv_anchors int32
// (n_cols, cap) whose guard is cap (never inside a window: starts are
// clamped to cap - win; the kernel also checks o < cap), and out f32
// (n_cols, cw, c_out). Pairs outside their window ride the dwov COO outside
// the kernel, so adding them here would count them twice. Operands are
// bf16 and products are summed in f32. cw and c_out are multiples of 8
// (the wrapper zero-pads conv0's 9 T3 columns to 16 and slices dW back).
//
// It is a GEMM, out_flat = T3^T @ G_all with G_all = [G_0 | ... |
// G_{n_cols-1}] (cap, n_cols * c_out), over a very long K (cap, up to
// 589,824 rows) into a small output (at most 8 x 1152 x 256 f32). At the L0
// shapes (cw = 288, c_out = 96) the dense product is 2 * cap * cw * 8 *
// c_out = 261 GFLOP against ~0.5 GB of inputs: near the bf16 ridge.
//
// Design. A block owns one (96 rows of cw) x (128 columns of G_all) output
// tile and one split of the rows, and walks the split 64 rows (one chunk)
// at a time. Eight warps multiply each chunk with bf16 mma.sync m16n8k16 on
// ldmatrix.trans fragments (both tiles hold K in rows), 48 x 32 of the tile
// a warp, accumulating in f32 registers. The load side is a ring of three
// shared-memory stages filled with 16-byte cp.async.cg copies, so two
// chunks are in flight while one is multiplied, one __syncthreads a chunk:
//
//   * T3 rows are copied as they are; G_all rows are gathered from g
//     through the column's inverse anchor. Rows out of their window, guard
//     anchors, columns past n_cols * c_out and rows past the split take the
//     zero-fill form (src-size 0, a valid dummy source), so no branch
//     stores zeros by hand.
//   * The gather's indices are resolved a chunk ahead of the copy: each
//     thread owns one 8-channel column of the G tile for the whole walk,
//     loads the inverse anchors and window starts of its rows for chunk
//     k + 3 into registers right after it issues the copies of chunk k + 2,
//     and only tests them when it issues chunk k + 3's copies an iteration
//     later, so a copy never waits on its own index loads.
//
// Grid: (cw / 96, n_cols * c_out / 128, splits), the split slowest, so the
// output tiles of one split run together and read its T3 and g rows from
// L2 after the first. 92,160 bytes of dynamic shared memory and at most 128
// registers a thread let two blocks share an SM; the wrapper sizes the
// split count to whole waves of those resident blocks. Each block writes
// its partial tile to a per-split slab; a second kernel adds the slabs in
// split order. No atomics, so the result is deterministic for given shapes.
//
// What bounds it, measured with the ablation modes below at the L0 shapes
// (cw = 288, c_out = 96) on an H100 SXM at 700 W: first the copies from L2
// into shared memory (each T3 chunk is read once per 128-column tile, each
// gathered g chunk once per 96-row tile, 3.7x the unique bytes; loads alone
// take ~78% of the kernel's time, at ~5 TB/s), then the mma.sync rate (the
// product alone ~53%: every row is multiplied, zeros of out-of-window pairs
// included). The two overlap only in part; the reduce pass is ~4%. The
// next step, while dw stays slower than one library GEMM, is wgmma fed by
// TMA (or warp-specialised producers) on this ring, with T3 chunks shared
// across the blocks of a split (cluster multicast) or wider tiles to cut
// the L2 re-reads.
//
// Ablation: lgs_dw_ablation runs the same launch in one of four modes, a
// template parameter, to split the time between the two sides: full (the
// kernel), no_sel (G rows read contiguously, row i for row i, no index
// loads), no_mma (the ring filled, no ldmatrix or mma), no_load (the
// product on whatever the ring holds, nothing copied). Only full computes
// dW.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 96;        // rows of cw per block
constexpr int BN = 128;       // columns of G_all per block
constexpr int BK = 64;        // T3 / G rows per chunk
constexpr int STAGES = 3;     // shared-memory ring depth
constexpr int THREADS = 256;  // 8 warps: 2 along cw x 4 along G_all
constexpr int PT = BM + 8;    // shared-memory pitches (bf16): +16 bytes
constexpr int PG = BN + 8;    // keep ldmatrix rows off one bank
constexpr int STAGE_T = BK * PT;  // bf16 elements of one stage's T3 tile
constexpr int STAGE_G = BK * PG;  // ... and of its G tile
constexpr int SMEM_BYTES = STAGES * (STAGE_T + STAGE_G) * 2;
constexpr int T_VECS = BK * BM / 8 / THREADS;  // 16-byte T3 copies a thread
constexpr int G_VECS = BK * BN / 8 / THREADS;  // 16-byte G copies a thread
constexpr int G_ROW_STEP = THREADS / (BN / 8);  // rows between them
static_assert(T_VECS * THREADS * 8 == BK * BM, "T3 tile split over threads");
static_assert(G_VECS * THREADS * 8 == BK * BN, "G tile split over threads");
static_assert(THREADS % (BN / 8) == 0, "a thread keeps one G column");

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

// 16 bytes global -> shared, asynchronously; with ok false the 16 bytes
// are zero-filled and nothing is read from src (which must still be a
// valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* src,
                                           bool ok) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

enum Mode { FULL = 0, NO_SEL = 1, NO_MMA = 2, NO_LOAD = 3 };

struct Args {
  const int32_t* inv_wstart;
  const int32_t* inv_anchors;
  const __nv_bfloat16* t3;
  const __nv_bfloat16* g;
  float* part;
  int cap, cw, c_out, n_cols, tile, win, rows_per_split;
};

// This thread's share of the G tile: one 8-channel column nn of G_all
// (column c, channels n..n+7 of g) on rows row0 + q * G_ROW_STEP.
struct GSlot {
  const int32_t* inv;  // inv_anchors row of column c
  const __nv_bfloat16* g;  // g + n
  int c, row0, col;  // column, first row, offset in the tile
  bool ok;           // nn < n_cols * c_out
};

// The inverse anchors and window starts of this thread's G rows of the
// chunk at r0; rows past the split (or a column past the end) get the
// guard cap, which never passes the window test.
__device__ __forceinline__ void fetch_idx(const Args& a, const GSlot& s,
                                          int r0, int r_end,
                                          int (&o)[G_VECS], int (&ws)[G_VECS]) {
#pragma unroll
  for (int q = 0; q < G_VECS; ++q) {
    const int i = r0 + s.row0 + q * G_ROW_STEP;
    if (s.ok && i < r_end) {
      o[q] = __ldg(s.inv + i);
      ws[q] = __ldg(a.inv_wstart + (i / a.tile) * a.n_cols + s.c);
    } else {
      o[q] = a.cap;
      ws[q] = 0;
    }
  }
}

// cp.async copies of the chunk at r0 into one ring stage: the T3 rows as
// they are, the G rows gathered through the resolved indices o / ws (no_sel:
// G row i for T3 row i).
template <int MODE>
__device__ __forceinline__ void issue_chunk(const Args& a, const GSlot& s,
                                            __nv_bfloat16* sT,
                                            __nv_bfloat16* sG, int r0,
                                            int r_end, int m0,
                                            const int (&o)[G_VECS],
                                            const int (&ws)[G_VECS]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < T_VECS; ++q) {
    const int v = tid + q * THREADS;
    const int row = v / (BM / 8), col = (v % (BM / 8)) * 8;
    const int i = r0 + row;
    const int m = m0 + col;
    const bool ok = i < r_end && m < a.cw;
    cp_async16(sT + row * PT + col,
               ok ? a.t3 + (int64_t)i * a.cw + m : a.t3, ok);
  }
#pragma unroll
  for (int q = 0; q < G_VECS; ++q) {
    const int row = s.row0 + q * G_ROW_STEP;
    const int src = MODE == NO_SEL ? r0 + row : o[q];
    const bool ok = MODE == NO_SEL
                        ? s.ok && src < r_end
                        : o[q] >= ws[q] && o[q] < ws[q] + a.win && o[q] < a.cap;
    cp_async16(sG + row * PG + s.col,
               ok ? s.g + (int64_t)src * a.c_out : a.g, ok);
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) dw_kernel(Args a) {
  constexpr bool kIdx = MODE == FULL || MODE == NO_MMA;  // gathers through o
  constexpr bool kLoad = MODE != NO_LOAD;
  constexpr bool kMma = MODE != NO_MMA;
  extern __shared__ __align__(16) unsigned char smem[];
  // [STAGES][BK][PT] T3 tiles, then [STAGES][BK][PG] G tiles
  __nv_bfloat16* const ring_t = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const ring_g = ring_t + STAGES * STAGE_T;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int r_begin = blockIdx.z * a.rows_per_split;
  const int r_end = min(r_begin + a.rows_per_split, a.cap);
  const int n_chunks = (r_end - r_begin + BK - 1) / BK;
  const int n_total = a.n_cols * a.c_out;

  GSlot s;
  s.col = (tid % (BN / 8)) * 8;
  s.row0 = tid / (BN / 8);
  const int nn = n0 + s.col;
  s.ok = nn < n_total;
  s.c = s.ok ? nn / a.c_out : 0;
  s.inv = a.inv_anchors + (int64_t)s.c * a.cap;
  s.g = a.g + (s.ok ? nn - s.c * a.c_out : 0);

  // warp tile: 48 rows of cw x 32 columns of G_all
  const int wm = (warp >> 2) * 48, wn = (warp & 3) * 32;
  float acc[3][4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  // ldmatrix row addresses: lane L feeds row L % 8 of matrix L / 8
  const int lr = lane & 7, lj = lane >> 3;
  const int a_row = lr + ((lj >> 1) << 3), a_col = (lj & 1) << 3;
  const int b_row = lr + ((lj & 1) << 3), b_col = (lj >> 1) << 3;

  // prologue: chunks 0 .. STAGES - 2 in flight, the indices of the next
  // one loading
  int o[G_VECS] = {}, ws[G_VECS] = {};
  if constexpr (kIdx) fetch_idx(a, s, r_begin, r_end, o, ws);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (kLoad && st < n_chunks)
      issue_chunk<MODE>(a, s, ring_t + st * STAGE_T, ring_g + st * STAGE_G,
                        r_begin + st * BK, r_end, m0, o, ws);
    if constexpr (kIdx)
      fetch_idx(a, s, r_begin + (st + 1) * BK, r_end, o, ws);
    cp_async_commit();
  }

  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk k landed
    __syncthreads();  // everyone's landed; everyone is done with chunk k - 1
    // refill the stage chunk k - 1 used with chunk k + STAGES - 1, whose
    // indices arrived during chunk k - 1's product; then start loading the
    // indices of the chunk after it
    const int kn = k + STAGES - 1;
    const int sn = kn % STAGES;
    if (kLoad && kn < n_chunks)
      issue_chunk<MODE>(a, s, ring_t + sn * STAGE_T, ring_g + sn * STAGE_G,
                        r_begin + kn * BK, r_end, m0, o, ws);
    if constexpr (kIdx)
      fetch_idx(a, s, r_begin + (kn + 1) * BK, r_end, o, ws);
    cp_async_commit();  // possibly empty: keeps the group count per chunk
    if constexpr (!kMma) continue;

    const __nv_bfloat16* sT = ring_t + (k % STAGES) * STAGE_T;
    const __nv_bfloat16* sG = ring_g + (k % STAGES) * STAGE_G;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[3][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
        ldmatrix_x4_trans(af[mi],
                          sT + (kk + a_row) * PT + wm + mi * 16 + a_col);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bf[nj],
                          sG + (kk + b_row) * PG + wn + nj * 16 + b_col);
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // partial tile -> this split's slab (split, cw, n_total)
  float* slab = a.part + (int64_t)blockIdx.z * a.cw * n_total;
  const int gq = lane >> 2, tq = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 3; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + tq;
      if (col >= n_total) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + gq + h * 8;
        if (m >= a.cw) continue;
        float2* dst =
            reinterpret_cast<float2*>(slab + (int64_t)m * n_total + col);
        *dst = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// out[c, m, n] = sum over splits, in split order, of part[s, m, c*c_out + n]
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int n_split, int cw,
                                 int c_out, int n_cols) {
  const int64_t total = (int64_t)n_cols * cw * c_out;
  const int64_t n_total = (int64_t)n_cols * c_out;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int n = e % c_out;
    const int64_t cm = e / c_out;
    const int m = cm % cw;
    const int c = cm / cw;
    const float* p = part + (int64_t)m * n_total + (int64_t)c * c_out + n;
    float s = 0.f;
    for (int k = 0; k < n_split; ++k) s += p[(int64_t)k * cw * n_total];
    out[e] = s;
  }
}

// Opt in to the ring's dynamic shared memory (above the 48 KB default) and
// the largest shared-memory carveout, so two blocks fit on an SM.
template <int MODE>
cudaError_t dw_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      dw_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(dw_kernel<MODE>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int MODE>
int dw_launch(const void* inv_wstart, const void* inv_anchors, const void* t3,
              const void* g, void* part, void* out, int cap, int cw,
              int c_out, int n_cols, int tile, int win, int rows_per_split,
              int n_split, cudaStream_t s) {
  cudaError_t err = dw_attributes<MODE>();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{static_cast<const int32_t*>(inv_wstart),
         static_cast<const int32_t*>(inv_anchors),
         static_cast<const __nv_bfloat16*>(t3),
         static_cast<const __nv_bfloat16*>(g),
         static_cast<float*>(part),
         cap, cw, c_out, n_cols, tile, win, rows_per_split};
  const dim3 grid((cw + BM - 1) / BM, (n_cols * c_out + BN - 1) / BN, n_split);
  dw_kernel<MODE><<<grid, THREADS, SMEM_BYTES, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = (int64_t)n_cols * cw * c_out;
  int blocks = static_cast<int>((total + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  dw_reduce_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(part),
                                          static_cast<float*>(out), n_split,
                                          cw, c_out, n_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers,
// t3 and g 16-byte aligned; ``part`` is scratch of n_split * cw * n_cols *
// c_out floats; cw and c_out must be multiples of 8. Both launches go on
// ``stream`` and nothing synchronises. Returns the first CUDA error of the
// set-up and the two launches.
extern "C" int lgs_dw(const void* inv_wstart, const void* inv_anchors,
                      const void* t3, const void* g, void* part, void* out,
                      int cap, int cw, int c_out, int n_cols, int tile,
                      int win, int rows_per_split, int n_split, void* stream) {
  return dw_launch<FULL>(inv_wstart, inv_anchors, t3, g, part, out, cap, cw,
                         c_out, n_cols, tile, win, rows_per_split, n_split,
                         static_cast<cudaStream_t>(stream));
}

// The same launch in ablation mode ``mode`` (0 full, 1 no_sel, 2 no_mma,
// 3 no_load); only full computes dW. Returns a CUDA error code, or
// cudaErrorInvalidValue for an unknown mode.
extern "C" int lgs_dw_ablation(const void* inv_wstart, const void* inv_anchors,
                               const void* t3, const void* g, void* part,
                               void* out, int cap, int cw, int c_out,
                               int n_cols, int tile, int win,
                               int rows_per_split, int n_split, int mode,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DW_MODE_CASE(M)                                                      \
  case M:                                                                    \
    return dw_launch<M>(inv_wstart, inv_anchors, t3, g, part, out, cap, cw, \
                        c_out, n_cols, tile, win, rows_per_split, n_split, s);
  switch (mode) {
    DW_MODE_CASE(FULL)
    DW_MODE_CASE(NO_SEL)
    DW_MODE_CASE(NO_MMA)
    DW_MODE_CASE(NO_LOAD)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DW_MODE_CASE
}

// The launch geometry compiled in, for the wrapper to check its own copy
// against and for reports: cfg = {BM, BN, BK, STAGES, THREADS, dynamic
// shared memory bytes a block, blocks an SM holds (the occupancy the
// runtime computes for those)}. Returns a CUDA error code.
extern "C" int lgs_dw_config(int* cfg) {
  cudaError_t err = dw_attributes<FULL>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dw_kernel<FULL>, THREADS, SMEM_BYTES);
  const int vals[7] = {BM, BN, BK, STAGES, THREADS, SMEM_BYTES, per_sm};
  for (int i = 0; i < 7; ++i) cfg[i] = vals[i];
  return static_cast<int>(err);
}
