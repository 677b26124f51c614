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
// bf16 and products are summed in f32.
//
// What bounds it on this card: it is a GEMM, out_flat = T3^T @ G_all with
// G_all = [G_0 | ... | G_{n_cols-1}] (cap, n_cols * c_out), over a very long
// K (cap, up to 589,824 rows) into a small output (at most 8 x 1152 x 256
// f32). At the L0 shapes (cw = 288, c_out = 96) it needs ~2 * cap * cw *
// 8 * c_out = ~260 GFLOP against ~0.5 GB of inputs: near the bf16 ridge
// (~295 operations per byte), so the tensor cores are worth having.
//
// The simple design: split K (the rows) over blocks. A block owns one
// (64-row block of cw, 128-column block of G_all, row split) output tile.
// It walks its rows 32 at a time: the T3 rows go to shared memory as they
// are, and each G_all row is gathered there from g through its column's
// inverse anchor, or zeroed when the window test fails. Eight warps multiply
// the two tiles with bf16 mma.sync m16n8k16 (fragments loaded with
// ldmatrix.trans, since both tiles hold K in rows), accumulating in f32
// registers. The next row chunk is loaded into registers while the current
// one is multiplied. Each block writes its partial tile to a per-split
// slab; a second kernel adds the slabs in split order. No atomics, so the
// result is deterministic for given shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of cw per block
constexpr int BN = 128;       // columns of G_all per block
constexpr int BK = 32;        // T3 / G rows per step
constexpr int THREADS = 256;  // 8 warps: 2 along cw x 4 along G_all
constexpr int PT = BM + 8;    // shared-memory pitches (bf16): +16 bytes
constexpr int PG = BN + 8;    // keep ldmatrix rows off one bank
constexpr int G_VECS = BK * BN / 8 / THREADS;  // 16-byte G loads per thread

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

struct Args {
  const int32_t* inv_wstart;
  const int32_t* inv_anchors;
  const __nv_bfloat16* t3;
  const __nv_bfloat16* g;
  float* part;
  int cap, cw, c_out, n_cols, tile, win, rows_per_split;
};

// 8 T3 values of row i, columns m..m+7 (zeros past the row or the split).
__device__ __forceinline__ uint4 load_t3(const Args& a, int64_t i,
                                         int64_t r_end, int m) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (i >= r_end) return v;
  const __nv_bfloat16* row = a.t3 + i * a.cw;
  if ((a.cw & 7) == 0 && m + 8 <= a.cw) {
    v = *reinterpret_cast<const uint4*>(row + m);
  } else {
    // cw not a multiple of 8 (conv0: cw = 9): element by element
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (m + j < a.cw) e[j] = row[m + j];
  }
  return v;
}

// 8 G_all values of row i, columns nn..nn+7 (all in one column c since
// c_out is a multiple of 8): g[o, n..n+7] when o is in its window.
__device__ __forceinline__ uint4 load_g(const Args& a, int64_t i,
                                        int64_t r_end, int nn) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (i >= r_end || nn >= a.n_cols * a.c_out) return v;
  const int c = nn / a.c_out;
  const int n = nn - c * a.c_out;
  const int o = a.inv_anchors[(int64_t)c * a.cap + i];
  const int ws = a.inv_wstart[(i / a.tile) * a.n_cols + c];
  if (o >= ws && o < ws + a.win && o < a.cap)
    v = *reinterpret_cast<const uint4*>(a.g + (int64_t)o * a.c_out + n);
  return v;
}

__global__ void __launch_bounds__(THREADS, 2) dw_kernel(Args a) {
  __shared__ __align__(16) __nv_bfloat16 sT[BK][PT];
  __shared__ __align__(16) __nv_bfloat16 sG[BK][PG];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int64_t r_begin = (int64_t)blockIdx.z * a.rows_per_split;
  const int64_t r_end =
      r_begin + a.rows_per_split < a.cap ? r_begin + a.rows_per_split : a.cap;
  const int n_total = a.n_cols * a.c_out;

  // this thread's share of each tile load
  const int t_row = tid / (BM / 8), t_col = (tid % (BM / 8)) * 8;
  int g_row[G_VECS], g_col[G_VECS];
#pragma unroll
  for (int q = 0; q < G_VECS; ++q) {
    const int v = tid + q * THREADS;
    g_row[q] = v / (BN / 8);
    g_col[q] = (v % (BN / 8)) * 8;
  }

  // warp tile: 32 rows of cw x 32 columns of G_all
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  // ldmatrix row addresses: lane L feeds row L % 8 of matrix L / 8
  const int lr = lane & 7, lj = lane >> 3;
  const int a_row = lr + ((lj >> 1) << 3), a_col = (lj & 1) << 3;
  const int b_row = lr + ((lj & 1) << 3), b_col = (lj >> 1) << 3;

  uint4 t_next = load_t3(a, r_begin + t_row, r_end, m0 + t_col);
  uint4 g_next[G_VECS];
#pragma unroll
  for (int q = 0; q < G_VECS; ++q)
    g_next[q] = load_g(a, r_begin + g_row[q], r_end, n0 + g_col[q]);

  for (int64_t r0 = r_begin; r0 < r_end; r0 += BK) {
    *reinterpret_cast<uint4*>(&sT[t_row][t_col]) = t_next;
#pragma unroll
    for (int q = 0; q < G_VECS; ++q)
      *reinterpret_cast<uint4*>(&sG[g_row[q]][g_col[q]]) = g_next[q];
    __syncthreads();
    if (r0 + BK < r_end) {  // prefetch the next chunk into registers
      t_next = load_t3(a, r0 + BK + t_row, r_end, m0 + t_col);
#pragma unroll
      for (int q = 0; q < G_VECS; ++q)
        g_next[q] = load_g(a, r0 + BK + g_row[q], r_end, n0 + g_col[q]);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(af[mi], &sT[kk + a_row][wm + mi * 16 + a_col]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bf[nj], &sG[kk + b_row][wn + nj * 16 + b_col]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  // partial tile -> this split's slab (split, cw, n_total)
  float* slab = a.part + (int64_t)blockIdx.z * a.cw * n_total;
  const int gq = lane >> 2, tq = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int nn = n0 + wn + ni * 8 + tq;
      if (nn >= n_total) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + gq + h * 8;
        if (m >= a.cw) continue;
        float2* dst = reinterpret_cast<float2*>(slab + (int64_t)m * n_total + nn);
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

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// ``part`` is scratch of n_split * cw * n_cols * c_out floats; c_out must be
// a multiple of 8. Both launches go on ``stream`` and nothing synchronises.
// Returns the first CUDA error of the two launches.
extern "C" int lgs_dw(const void* inv_wstart, const void* inv_anchors,
                      const void* t3, const void* g, void* part, void* out,
                      int cap, int cw, int c_out, int n_cols, int tile,
                      int win, int rows_per_split, int n_split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const int32_t*>(inv_wstart),
         static_cast<const int32_t*>(inv_anchors),
         static_cast<const __nv_bfloat16*>(t3),
         static_cast<const __nv_bfloat16*>(g),
         static_cast<float*>(part),
         cap, cw, c_out, n_cols, tile, win, rows_per_split};
  const dim3 grid((cw + BM - 1) / BM, (n_cols * c_out + BN - 1) / BN, n_split);
  dw_kernel<<<grid, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = (int64_t)n_cols * cw * c_out;
  int blocks = static_cast<int>((total + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  dw_reduce_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(part),
                                          static_cast<float*>(out), n_split,
                                          cw, c_out, n_cols);
  return static_cast<int>(cudaGetLastError());
}
