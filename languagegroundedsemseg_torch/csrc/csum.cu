// Child sum of the strided (down) sparse convs, for Hopper (sm_90a).
//
// Replaces: _csum_kernel in languagegroundedsemseg_tpu/ops/onehot_conv.py
// (launched by _run_csum). Contract, per output row o of tile t = o / tile:
//
//   out[o] = sum_g sum_{i in [ws_{t,g}, ws_{t,g} + win) n [0, cap_in)}
//                [parent_g[g, i] == o] * P[i]
//
// with P[i] = x[i] @ W[kslot[i]] in bf16 (cap_in, c_run), parent_g int32
// (n_groups, cap_in) whose non-members hold cap_out, and window starts int32
// (n_tiles*n_groups,), tile-major. Children outside their tile's window are
// served by the overflow COO outside the kernel; a child whose parent lies in
// another tile is skipped here (never clamped), because that tile counts it.
// Output rows with no child are 0. Sums are f32.
//
// What bounds it on this card: bytes. Every P row belongs to one tile, so
// the sum reads each summed P row once (hits * c_run bf16) and writes
// cap_out * c_run f32; the parents of a window are n_groups * win int32 a
// tile, read mostly from L2 (windows of neighbouring tiles overlap). There
// is no arithmetic to speak of. The work is sparse and data-dependent,
// so what a design has to beat is the latency of dependent loads.
//
// Design: one block per output tile (times a few channel splits where the
// tiles alone are too few blocks to fill the card), 256 threads, and one
// chain of global round trips a block:
//
//   1. Stage. All threads load the tile's n_groups * win window parents
//      with 16-byte loads (a scalar head and tail where a window start is
//      not 4-aligned), all in flight together, and keep each as its local
//      row p - t*tile, or -1 when it lies outside the tile (other tiles,
//      non-members) or past cap_in. This is the only global load before
//      the sum.
//   2. Bucket by local row, stably, in shared memory. Each warp owns a
//      contiguous slice of the window; it counts its hits per row
//      (__match_any_sync peers, the lowest lane adds). One pass turns the
//      (row, warp) counts into offsets: rows in order, warps in order
//      within a row. A second walk places each hit's input row at its
//      warp's offset plus its rank among its peers in the round, so every
//      row's children lie in (group, window row) order. The list holds
//      every entry of the window (HIT_CAP), not just the <= 8 children of
//      a real partition.
//   3. Sum in registers. One thread per (local row, 8-channel vector):
//      it issues up to BATCH 16-byte loads of its children's P vectors
//      before the first add (a real row has 2-3 children, at most 8), adds
//      them in bucket order in f32, and writes its 8 f32 with two 16-byte
//      stores. Consecutive threads take consecutive vectors of a row, so P
//      reads and out writes are coalesced row segments. Rows with no child
//      write zeros: no accumulator, no zero pass, no write-back loop.
//
// The sum order is fixed by the window order alone, and a channel split
// changes no sum's order: a second launch is bit-equal to the first. No
// global atomics.
//
// Occupancy: a block's latency chain (stage, bucket, sum) is hidden only by
// the other blocks of its SM, so registers are capped at 48 a thread (five
// blocks an SM; 29,200 bytes of shared memory a block at the L0->L1 map)
// and a batch is 4 loads deep, which covers most rows' children at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HIT_CAP = 8192;   // window entries (n_groups * win) a block stages
constexpr int BATCH = 4;        // child P vectors loaded before the first add
constexpr int MIN_BLOCKS = 5;   // blocks an SM holds: at most 48 registers
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory of a launch: the hit list (int32, one slot per
// window entry), the (warp, row) counts turned offsets (int32), the row
// starts (int32, tile + 1), the staged local rows (int16, one per entry;
// a tile that fits in shared memory has far fewer than 32,768 rows).
__host__ __device__ constexpr int smem_bytes(int tile, int entries) {
  return (entries * 4 + (WARPS * tile + tile + 1) * 4 + entries * 2 + 15) /
         16 * 16;
}

__device__ __forceinline__ int local_row(int p, int lo, int tile) {
  const int r = p - lo;
  return static_cast<unsigned>(r) < static_cast<unsigned>(tile) ? r : -1;
}

__device__ __forceinline__ void add8(float (&acc)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] += __uint_as_float(w[k] << 16);
    acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    csum_kernel(const int32_t* __restrict__ wstart,
                const int32_t* __restrict__ parent_g,
                const __nv_bfloat16* __restrict__ pall,
                float* __restrict__ out, int cap_in, int c_run, int tile,
                int win, int n_groups, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int entries = n_groups * win;
  int32_t* const s_list = reinterpret_cast<int32_t*>(smem);
  int32_t* const s_off = s_list + entries;      // [WARPS][tile]
  int32_t* const s_start = s_off + WARPS * tile;  // [tile + 1]
  int16_t* const s_loc = reinterpret_cast<int16_t*>(s_start + tile + 1);
  __shared__ int s_warp_sum[WARPS];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = t * tile;

  for (int k = tid; k < WARPS * tile; k += THREADS) s_off[k] = 0;

  // 1. stage the window's parents as local rows
  for (int g = 0; g < n_groups; ++g) {
    const int ws = __ldg(wstart + (int64_t)t * n_groups + g);
    const int begin = max(ws, 0);
    const int end = min(ws + win, cap_in);
    // entries [0, j_lo) lie before row 0, [j_hi, win) past cap_in: -1
    const int j_lo = min(max(begin - ws, 0), win);
    const int j_hi = max(min(end - ws, win), j_lo);
    int16_t* const loc = s_loc + g * win;
    for (int j = tid; j < j_lo; j += THREADS) loc[j] = -1;
    for (int j = j_hi + tid; j < win; j += THREADS) loc[j] = -1;
    const int n = j_hi - j_lo;
    if (n <= 0) continue;
    const int32_t* const src = parent_g + (int64_t)g * cap_in + begin;
    int16_t* const dst = loc + j_lo;
    const int head =
        min(static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(src) & 15u)) &
                              15u) >> 2),
            n);
    const int nvec = (n - head) >> 2;
    const int tail = head + 4 * nvec;
    if (tid < head) dst[tid] = local_row(__ldg(src + tid), lo, tile);
    for (int j = tail + tid; j < n; j += THREADS)
      dst[j] = local_row(__ldg(src + j), lo, tile);
    const int4* const vsrc = reinterpret_cast<const int4*>(src + head);
    for (int v0 = tid; v0 < nvec; v0 += 4 * THREADS) {
      int4 q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * THREADS;
        if (v < nvec) q[u] = __ldg(vsrc + v);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * THREADS;
        if (v < nvec) {
          int16_t* const d = dst + head + 4 * v;
          d[0] = local_row(q[u].x, lo, tile);
          d[1] = local_row(q[u].y, lo, tile);
          d[2] = local_row(q[u].z, lo, tile);
          d[3] = local_row(q[u].w, lo, tile);
        }
      }
    }
  }
  __syncthreads();

  // 2a. hits per (warp, row): each warp walks its own contiguous slice
  const int per_warp = (entries + WARPS - 1) / WARPS;
  const int e0 = warp * per_warp;
  const int e1 = min(e0 + per_warp, entries);
  int32_t* const my_off = s_off + warp * tile;
  for (int b = e0; b < e1; b += 32) {
    const int e = b + lane;
    const int r = e < e1 ? s_loc[e] : -1;
    if (!__any_sync(FULL, r >= 0)) continue;
    const unsigned peers = __match_any_sync(FULL, r);
    if (r >= 0 && lane == __ffs(peers) - 1) my_off[r] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // 2b. offsets: rows in order, then warps in order within a row. Thread
  // tid owns rows [tid * rpt, tid * rpt + rpt).
  const int rpt = (tile + THREADS - 1) / THREADS;
  const int r0 = min(tid * rpt, tile);
  const int r1 = min(r0 + rpt, tile);
  int mine = 0;
  for (int r = r0; r < r1; ++r)
    for (int w = 0; w < WARPS; ++w) mine += s_off[w * tile + r];
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp_sum[warp] = incl;
  __syncthreads();
  int run = incl - mine;
  for (int w = 0; w < warp; ++w) run += s_warp_sum[w];
  for (int r = r0; r < r1; ++r) {
    s_start[r] = run;
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_off[w * tile + r];
      s_off[w * tile + r] = run;
      run += c;
    }
  }
  if (tid == THREADS - 1) s_start[tile] = run;
  __syncthreads();

  // 2c. place each hit's input row, stably
  for (int b = e0; b < e1; b += 32) {
    const int e = b + lane;
    const int r = e < e1 ? s_loc[e] : -1;
    if (!__any_sync(FULL, r >= 0)) continue;
    const unsigned peers = __match_any_sync(FULL, r);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (r >= 0 && lane == leader) {
      base = my_off[r];
      my_off[r] = base + __popc(peers);
    }
    base = __shfl_sync(FULL, base, leader);
    if (r >= 0) {
      const int g = e / win;
      const int i = __ldg(wstart + (int64_t)t * n_groups + g) + (e - g * win);
      s_list[base + __popc(peers & ((1u << lane) - 1u))] = i;
    }
    __syncwarp();
  }
  __syncthreads();

  // 3. one thread per (local row, 8-channel vector) of this channel split
  const int c0 = blockIdx.y * chunk;
  const int nv = min(chunk, c_run - c0) >> 3;
  const __nv_bfloat16* const pcol = pall + c0;
  float* const ocol = out + (int64_t)lo * c_run + c0;
  for (int item = tid; item < tile * nv; item += THREADS) {
    const int r = item / nv;
    const int v = item - r * nv;
    const int s = s_start[r];
    const int e = s_start[r + 1];
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = s; q < e; q += BATCH) {
      uint4 x[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        if (q + k < e)
          x[k] = __ldg(reinterpret_cast<const uint4*>(
              pcol + (int64_t)s_list[q + k] * c_run + 8 * v));
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        if (q + k < e) add8(acc, x[k]);
    }
    float4* const dst =
        reinterpret_cast<float4*>(ocol + (int64_t)r * c_run + 8 * v);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

cudaError_t csum_attributes(int smem) {
  return cudaFuncSetAttribute(
      csum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers,
// pall and out 16-byte aligned. ``chunk`` channels per block (a multiple of
// 8; the grid is (cap_out / tile, ceil(c_run / chunk))), ``smem`` the
// dynamic shared memory the wrapper planned, which must equal this file's
// smem_bytes(tile, n_groups * win). Returns cudaErrorInvalidValue for a
// plan this kernel does not take, else the first CUDA error of the
// attribute call or the launch.
extern "C" int lgs_csum(const void* wstart, const void* parent_g,
                        const void* pall, void* out, int cap_in, int cap_out,
                        int c_run, int tile, int win, int n_groups, int chunk,
                        int smem, void* stream) {
  const int64_t entries = (int64_t)n_groups * win;
  if (tile <= 0 || cap_out % tile || win <= 0 || n_groups <= 0 ||
      entries > HIT_CAP || c_run <= 0 || c_run % 8 || chunk <= 0 ||
      chunk % 8 || smem != smem_bytes(tile, (int)entries))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = csum_attributes(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cap_out / tile, (c_run + chunk - 1) / chunk);
  csum_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wstart),
      static_cast<const int32_t*>(parent_g),
      static_cast<const __nv_bfloat16*>(pall), static_cast<float*>(out), cap_in,
      c_run, tile, win, n_groups, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The constants compiled in, for the wrapper to check its own copy against
// and for reports: cfg = {THREADS, HIT_CAP, BATCH, smem_bytes(tile,
// entries), blocks an SM holds at that shared memory (the occupancy the
// runtime computes)}. Returns a CUDA error code.
extern "C" int lgs_csum_config(int* cfg, int tile, int entries) {
  const int smem = smem_bytes(tile, entries);
  cudaError_t err = csum_attributes(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, csum_kernel,
                                                      THREADS, smem);
  const int vals[5] = {THREADS, HIT_CAP, BATCH, smem, per_sm};
  for (int i = 0; i < 5; ++i) cfg[i] = vals[i];
  return static_cast<int>(err);
}
