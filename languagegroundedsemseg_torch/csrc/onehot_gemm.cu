// Windowed row gather followed by an f32 projection GEMM, for Hopper
// (sm_90a), on the bf16 tensor cores.
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
// are summed in f32.
//
// The arithmetic: the left operand is bf16 already, and an f32 W splits
// exactly into three bf16 parts, Wh = bf16(W), Wm = bf16(W - Wh), Wl =
// bf16(W - Wh - Wm) (8 + 8 + 8 significant bits for f32's 24), each
// rounded to nearest. A product of two bf16 values is exact in f32, so
// A Wh + A Wm + A Wl on the bf16 tensor cores with f32 accumulators is the
// same function; only the order of the f32 sums differs. The split is
// exact for every finite W with |W| < 2^127 (2 - 2^-8) (bf16(W) does not
// round to infinity) and |W| >= 2^-110 or W = 0 (the last part's lowest bit
// is not below bf16's least subnormal, 2^-133); below that the lowest bits
// of W are lost (an error under 2^-133 an element). A prepass writes the
// three parts into a (3, cw_pad, c_out) bf16 buffer the caller allocates,
// rows past cw zero, cw_pad = cw rounded up to 32: 221 KB at the script's
// shapes, so every block reads it from L2.
//
// What bounds it on this card: at the script's shapes (n = 262,144, cw =
// 384, c_out = 96, every anchor in its window) it moves 350.5 MB from
// device memory (161,900 distinct f32 t3 rows once, the anchors, W, the f32
// output): 0.105 ms at 3.35 TB/s, the bound. Its 19.3 GFLOP run three
// times on the tensor cores, 58.0 GFLOP: 0.059 ms at 989 TFLOP/s (the rate
// of wgmma; mma.sync reaches less). The gathered rows (402.6 MB) and W's
// parts (1,024 blocks x 221 KB = 226 MB) cross from L2 into shared memory:
// 0.126 ms at ~5 TB/s. Each 32-channel step of a block reads ~136 KB of
// fragments from shared memory beside the 52 KB its copies write. On an
// H100 SXM at 700 W (PERF.md section 6) the kernel takes 0.195 ms on the
// device, 1.9x the bound, and 0.192 ms with every row out of its window
// (nothing gathered): the gather is hidden, and the products (58.0 GFLOP
// at ~300 TFLOP/s through mma.sync, with their fragment loads and
// conversions) and each block's fill and drain set the pace. 16 warps of
// 32 x 48 (0.208 ms), persistent 16-warp blocks (0.205) and 64-channel
// steps in two stages (0.200) were measured slower.
//
// Design: a block owns BM = 256 output rows and all c_out columns (8
// warps: 4 along the rows x 2 along c_out for c_out 32 and 96, each 64 x
// c_out / 2; 8 x 1 for c_out 16, each 32 x 16). It window-tests its rows'
// anchors once into shared memory (sSrc), then walks cw in 32-channel
// steps through a ring of four shared-memory stages filled with 16-byte
// cp.async.cg copies: the rows' f32 chunks gathered through sSrc (an
// out-of-window row or a channel past cw takes the zero-fill form,
// src-size 0, and reads nothing) and the matching 32 rows of W's three
// parts. Three steps are in flight while one is multiplied, with one
// __syncthreads a step. A thread's copies are eight row pointers and a
// mask of hits set once plus the step's channel offset: the step loop
// does no division. The f32 rows are stored unpadded with their 16-byte
// chunks XOR-swizzled by (row & 3) << 1, so a warp's float2 fragment reads
// (4 rows x 32 bytes a half-warp) hit 32 distinct banks and every cp.async
// destination stays 16-byte aligned; W's rows are padded by 16 bytes for
// ldmatrix. A fragments are built from the f32 stage with float2 loads and
// one cvt.rn.bf16x2.f32 each (the contract's rounding of t3), B fragments
// come from ldmatrix.trans, and each (A, B) pair feeds three bf16 mma.sync
// m16n8k16, Wh then Wm then Wl, into one f32 accumulator: a fixed order,
// so a relaunch is bit-equal. Shared memory: 4 x (32 KB of rows + 19.5 KB
// of W) + 1 KB of resolved rows = 211,968 B at c_out 96, one block an SM
// (1,024 blocks, 7.8 waves on 132 SMs). 64-row warp tiles read W's
// fragments from shared memory half as often as 32-row ones (16 warps),
// for 96 f32 accumulators a thread; measured faster on the card.
//
// Trouble spots: tensor-core f32 accumulation does not round like IEEE
// (partial sums are truncated), so the error against the plain version
// grows with the number of mma a sum takes (3 x cw / 16); the card tests
// and chip_smoke.py hold it to 1e-5 of max |ref|. Registers: a 16-warp
// block may hold 128 a thread, which the first 16-warp version overran
// (28 bytes of spills); 8 warps may hold 255.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 256;       // output rows per block
constexpr int BK = 32;        // channels of t3 (rows of W) per step
constexpr int KK = BK / 16;   // k16 slices a step
constexpr int STAGES = 4;     // shared-memory ring depth
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int PARTS = 3;      // W = Wh + Wm + Wl
constexpr int SPLIT_THREADS = 256;  // prepass block
constexpr int CHUNKS = BK / 4;      // 16-byte chunks of an f32 row a step
constexpr int A_VECS = BM * CHUNKS / THREADS;  // t3 copies a thread a step
constexpr int A_ROW_STEP = THREADS / CHUNKS;   // rows between them
static_assert(A_VECS * THREADS == BM * CHUNKS, "t3 chunk split over threads");
static_assert(CHUNKS == 8 && A_ROW_STEP % 4 == 0,
              "the swizzle permutes 8 chunks by row & 3");

// The warps' tiling of a block's BM x c_out output, c_out = 16 * NB: with NB
// even, WARPS / 2 warps along the rows x 2 along c_out; else WARPS x 1.
template <int NB>
struct Tiling {
  static constexpr int WN = NB % 2 == 0 ? 2 : 1;  // warps along c_out
  static constexpr int WM = BM / (WARPS / WN);    // rows a warp
  static constexpr int MI = WM / 16;              // m16 tiles a warp
  static constexpr int NBW = NB / WN;             // 16-column blocks a warp
  static constexpr int NTW = 2 * NBW;             // n8 tiles a warp
};

// Dynamic shared memory of a block at c_out = nc: the ring (f32 t3 stages,
// unpadded; the three W parts' stages, bf16 rows padded by 8) and the
// resolved rows. ops/onehot_ablation.py:gemm_geometry keeps a copy.
constexpr int smem_bytes(int nc) {
  return STAGES * (BM * BK * 4 + PARTS * BK * (nc + 8) * 2) + BM * 4;
}
static_assert(smem_bytes(96) <= 232448, "227 KB a block");

struct Args {
  const int32_t* wstart;
  const int32_t* anchors;
  const float* t3;
  const __nv_bfloat16* wsplit;
  float* out;
  int n, n_rows, cw, cw_pad, c_out, tile, win;
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
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

// Two f32 values rounded to nearest bf16 and packed: lo in bits 0-15.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
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

// The prepass: W's three bf16 parts, plane p of parts (3, cw_pad, c_out)
// holding part p, rows cw .. cw_pad - 1 zero. The residuals are exact f32
// differences (no contraction: __fsub_rn).
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_bf16x3_kernel(const float* w, __nv_bfloat16* parts, int cw,
                        int cw_pad, int c_out) {
  const int64_t plane = (int64_t)cw_pad * c_out;
  const int64_t i = (int64_t)blockIdx.x * SPLIT_THREADS + threadIdx.x;
  if (i >= plane) return;
  const float x = i < (int64_t)cw * c_out ? w[i] : 0.f;
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(h));
  const __nv_bfloat16 m = __float2bfloat16_rn(r1);
  const float r2 = __fsub_rn(r1, __bfloat162float(m));
  parts[i] = h;
  parts[plane + i] = m;
  parts[2 * plane + i] = __float2bfloat16_rn(r2);
}

// NB = c_out / 16 blocks of 16 output columns
template <int NB>
__global__ void __launch_bounds__(THREADS, 1) onehot_gemm_kernel(Args a) {
  using T = Tiling<NB>;
  constexpr int NC = 16 * NB;        // c_out
  constexpr int PW = NC + 8;         // bf16 pitch of a W row in shared memory
  constexpr int STAGE_A = BM * BK;   // f32 elements of a stage's t3 tile
  constexpr int STAGE_W = PARTS * BK * PW;  // bf16 elements of its W tiles
  constexpr int W_VECS = PARTS * BK * NC / 8;  // 16-byte W copies a step
  constexpr int W_PER = (W_VECS + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  // [STAGES][BM][BK] f32 t3 tiles (chunks swizzled), [STAGES][PARTS][BK][PW]
  // bf16 W tiles, [BM] resolved rows
  float* const ring_a = reinterpret_cast<float*>(smem);
  __nv_bfloat16* const ring_w =
      reinterpret_cast<__nv_bfloat16*>(ring_a + STAGES * STAGE_A);
  int* const sSrc = reinterpret_cast<int*>(ring_w + STAGES * STAGE_W);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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

  // This thread's copies, set once: chunk kc of rows ar + q * A_ROW_STEP
  // (a row pointer each, and a bit of `hits` set where the row is in its
  // window; a miss copies 0 bytes from row 0), at the chunk's swizzled
  // place; and its share of the step's W parts.
  const int kc = tid % CHUNKS;
  const int ar = tid / CHUNKS;
  const int kv = kc * 4;  // its first channel of the step's chunk
  const int a_dst = ar * BK + ((kc ^ ((ar & 3) << 1)) << 2);
  const float* arow[A_VECS];
  unsigned hits = 0;
#pragma unroll
  for (int q = 0; q < A_VECS; ++q) {
    const int src = sSrc[ar + q * A_ROW_STEP];
    arow[q] = a.t3 + (int64_t)(src >= 0 ? src : 0) * a.cw + kv;
    hits |= (src >= 0 ? 1u : 0u) << q;
  }
  int w_src[W_PER], w_dst[W_PER];
#pragma unroll
  for (int q = 0; q < W_PER; ++q) {
    const int v = tid + q * THREADS;
    const int p = v / (BK * NC / 8), e = v % (BK * NC / 8);
    const int kr = e / (NC / 8), c = (e % (NC / 8)) * 8;
    w_src[q] = (p * a.cw_pad + kr) * NC + c;
    w_dst[q] = (p * BK + kr) * PW + c;
  }

  // step k0 / BK into the stage at sA / sW
  auto issue = [&](int k0, float* sA, __nv_bfloat16* sW) {
    const bool kin = k0 + kv < a.cw;  // false only in a ragged last step
    const unsigned live = kin ? hits : 0u;
#pragma unroll
    for (int q = 0; q < A_VECS; ++q)
      cp_async16(sA + a_dst + q * A_ROW_STEP * BK, kin ? arow[q] + k0 : a.t3,
                 ((live >> q) & 1u) << 4);
    const __nv_bfloat16* wk = a.wsplit + (int64_t)k0 * NC;
#pragma unroll
    for (int q = 0; q < W_PER; ++q)
      if (W_VECS % THREADS == 0 || tid + q * THREADS < W_VECS)
        cp_async16(sW + w_dst[q], wk + w_src[q], 16);
  };

  const int n_steps = a.cw_pad / BK;
  // prologue: steps 0 .. STAGES - 2 in flight
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_steps)
      issue(st * BK, ring_a + st * STAGE_A, ring_w + st * STAGE_W);
    cp_async_commit();
  }

  float acc[T::MI][T::NTW][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int j = 0; j < T::NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  // Fragment addresses. A (m16 x k16, row-major): lane holds rows gq and
  // gq + 8, channels tq, tq + 1 and tq + 8, tq + 9 of the slice; its float2
  // sits in chunk ki * 4 + 2 * hc + tq / 4 of the row, swizzled by the
  // row's (row & 3) = (gq & 3). B: ldmatrix row addresses, lane L feeding
  // row L % 8 of matrix L / 8.
  const int gq = lane >> 2, tq = (lane & 3) * 2;
  const int wm = (warp / T::WN) * T::WM;         // the warp's first row
  const int wn = (warp % T::WN) * (NC / T::WN);  // ... and first column
  const int lr = lane & 7, lj = lane >> 3;
  const int b_r = lr + ((lj & 1) << 3), b_c = (lj >> 1) << 3;
  // the float2's place in the row: chunk (ki * 4 + 2 * hc) ^ ((gq & 3) << 1)
  // with bit 0 = tq / 4, offset tq % 4 in it; the slice's part of the chunk
  // (bits 3-4 of the float index) is XORed in as a constant
  const int a_lane = (((gq & 3) << 1 | (tq >> 2)) << 2) | (tq & 3);
  const int a_row = (wm + gq) * BK;

  int cur = 0;  // the stage step s reads
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step s landed
    __syncthreads();  // everyone's landed; everyone is done with step s - 1
    // refill the stage step s - 1 read with step s + STAGES - 1
    const int prev = cur == 0 ? STAGES - 1 : cur - 1;
    if (s + STAGES - 1 < n_steps)
      issue((s + STAGES - 1) * BK, ring_a + prev * STAGE_A,
            ring_w + prev * STAGE_W);
    cp_async_commit();  // possibly empty: keeps the group count per step
    const float* sA = ring_a + cur * STAGE_A + a_row;
    const __nv_bfloat16* sW = ring_w + cur * STAGE_W;
#pragma unroll
    for (int ki = 0; ki < KK; ++ki) {
      uint32_t af[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int hc = 0; hc < 2; ++hc)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float2 v = *reinterpret_cast<const float2*>(
                sA + (mi * 16 + hr * 8) * BK +
                (a_lane ^ ((ki * 4 + 2 * hc) << 2)));
            af[mi][hr + 2 * hc] = pack_bf16x2(v.x, v.y);
          }
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        uint32_t bf[T::NBW][4];
#pragma unroll
        for (int nb = 0; nb < T::NBW; ++nb)
          ldmatrix_x4_trans(
              bf[nb], sW + (p * BK + ki * 16 + b_r) * PW + wn + nb * 16 + b_c);
#pragma unroll
        for (int nb = 0; nb < T::NBW; ++nb)
#pragma unroll
          for (int mi = 0; mi < T::MI; ++mi) {
            mma_bf16(acc[mi][2 * nb], af[mi], bf[nb][0], bf[nb][1]);
            mma_bf16(acc[mi][2 * nb + 1], af[mi], bf[nb][2], bf[nb][3]);
          }
      }
    }
    cur = cur == STAGES - 1 ? 0 : cur + 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t o = r0 + wm + mi * 16 + gq + hr * 8;
      if (o >= a.n) continue;
#pragma unroll
      for (int j = 0; j < T::NTW; ++j)
        *reinterpret_cast<float2*>(a.out + o * NC + wn + j * 8 + tq) =
            make_float2(acc[mi][j][2 * hr], acc[mi][j][2 * hr + 1]);
    }
}

// Opt in to the block's dynamic shared memory (above the 48 KB default)
// and to the largest shared-memory carveout, once per instantiation and
// device (a bit per device; setting twice from two threads is harmless).
template <int NB>
cudaError_t set_attributes() {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(onehot_gemm_kernel<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(16 * NB));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(onehot_gemm_kernel<NB>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done |= bit;
  return err;
}

int cw_padded(int cw) { return (cw + BK - 1) / BK * BK; }

int launch_split(const float* w, __nv_bfloat16* parts, int cw, int c_out,
                 cudaStream_t s) {
  const int cw_pad = cw_padded(cw);
  const int64_t plane = (int64_t)cw_pad * c_out;
  const int blocks = static_cast<int>((plane + SPLIT_THREADS - 1) /
                                      SPLIT_THREADS);
  split_bf16x3_kernel<<<blocks, SPLIT_THREADS, 0, s>>>(w, parts, cw, cw_pad,
                                                       c_out);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch(const Args& a, const float* w, cudaStream_t s) {
  cudaError_t err = set_attributes<NB>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_split(w, const_cast<__nv_bfloat16*>(a.wsplit), a.cw,
                              a.c_out, s);
  if (rc != 0) return rc;
  const int blocks = (a.n + BM - 1) / BM;
  onehot_gemm_kernel<NB><<<blocks, THREADS, smem_bytes(16 * NB), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
cudaError_t occupancy(int* per_sm) {
  cudaError_t err = set_attributes<NB>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, onehot_gemm_kernel<NB>, THREADS, smem_bytes(16 * NB));
}

bool built_width(int c_out) {
  return c_out == 16 || c_out == 32 || c_out == 96;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers,
// t3 16-byte aligned; cw must be a multiple of 4, c_out 16, 32 or 96 (the
// widths built) and n at least 1 (the wrapper checks). wsplit is the
// caller's (3, cw_pad, c_out) bf16 scratch, cw_pad = cw rounded up to 32.
// Launches the prepass, then the product, on ``stream``; nothing
// synchronises. Returns the first CUDA error of the set-up and the
// launches, or cudaErrorInvalidValue for a c_out the kernel was not built
// for.
extern "C" int lgs_onehot_gemm(const void* wstart, const void* anchors,
                               const void* t3, const void* w, void* wsplit,
                               void* out, int n, int n_rows, int cw, int c_out,
                               int tile, int win, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const int32_t*>(wstart),
         static_cast<const int32_t*>(anchors),
         static_cast<const float*>(t3),
         static_cast<const __nv_bfloat16*>(wsplit),
         static_cast<float*>(out),
         n, n_rows, cw, cw_padded(cw), c_out, tile, win};
  const float* wf = static_cast<const float*>(w);
  switch (c_out) {
    case 16: return launch<1>(a, wf, s);
    case 32: return launch<2>(a, wf, s);
    case 96: return launch<6>(a, wf, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The prepass alone, for checks: W f32 (cw, c_out) into wsplit (3, cw_pad,
// c_out) bf16 on ``stream``. Returns the launch's CUDA error.
extern "C" int lgs_onehot_gemm_split(const void* w, void* wsplit, int cw,
                                     int c_out, void* stream) {
  if (!built_width(c_out)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_split(static_cast<const float*>(w),
                      static_cast<__nv_bfloat16*>(wsplit), cw, c_out,
                      static_cast<cudaStream_t>(stream));
}

// The launch geometry compiled in, for the wrapper to check its own copy
// against and for reports: cfg = {BM, BK, STAGES, THREADS, PARTS,
// SPLIT_THREADS, dynamic shared memory bytes a block at c_out, blocks an SM
// holds there (from the runtime)}. Returns a CUDA error code, or
// cudaErrorInvalidValue for a c_out not built.
extern "C" int lgs_onehot_gemm_config(int* cfg, int c_out) {
  int per_sm = 0;
  cudaError_t err;
  switch (c_out) {
    case 16: err = occupancy<1>(&per_sm); break;
    case 32: err = occupancy<2>(&per_sm); break;
    case 96: err = occupancy<6>(&per_sm); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vals[8] = {BM, BK, STAGES, THREADS, PARTS, SPLIT_THREADS,
                       smem_bytes(c_out), per_sm};
  for (int i = 0; i < 8; ++i) cfg[i] = vals[i];
  return static_cast<int>(err);
}
