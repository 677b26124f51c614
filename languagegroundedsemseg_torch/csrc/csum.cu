// Child sum of the strided (down) sparse convs, for Hopper (sm_90a).
//
// Replaces: _csum_kernel in languagegroundedsemseg_tpu/ops/onehot_conv.py
// (launched by _run_csum). Contract, per output row o of tile t = o / tile:
//
//   out[o] = sum_g sum_{i in [ws_{t,g}, ws_{t,g} + win)} [parent_g[i] == o] * P[i]
//
// with P[i] = x[i] @ W[kslot[i]] in bf16 (cap_in, c_run), parent_g int32
// (n_groups, cap_in) whose non-members hold cap_out, and window starts int32
// (n_tiles*n_groups,), tile-major. Children outside their tile's window are
// served by the overflow COO outside the kernel; a child whose parent lies in
// another tile is skipped here (never clamped), because that tile counts it.
//
// What bounds it on this card: bytes. Each block reads its window's parents
// (n_groups * win int32) and, for the rows whose parent lies in its tile,
// one P row of c_run bf16; it writes tile * c_run f32. Every P row belongs
// to one tile, so P is read about once in all.
//
// The simple design: the TPU built a one-hot selector and summed with a
// matmul; here the sum is a segmented accumulate. One block per (output
// tile, channel chunk) walks the groups and their window rows in order.
// Each thread owns one channel of the chunk and adds P[i, ch] into a
// shared-memory f32 accumulator row acc[parent - t*tile, ch]. A thread only
// ever touches its own channel column, so there are no atomics, no races
// and a fixed sum order (window order): the result is deterministic. The
// chunk is chosen by the launcher so tile * chunk * 4 bytes fits in shared
// memory (tile reaches 512 and c_run 256, so a whole tile does not).
//
// Only a few window rows belong to the tile (about tile * 8 / win), so a
// row-at-a-time walk waits on one parent load per row. Instead each warp
// reads 32 parents at once (one per lane, coalesced), ballots the rows
// whose parent lies in the tile, and visits just those, in window order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void csum_kernel(const int32_t* __restrict__ wstart,
                            const int32_t* __restrict__ parent_g,
                            const __nv_bfloat16* __restrict__ pall,
                            float* __restrict__ out, int cap_in, int c_run,
                            int tile, int win, int n_groups, int chunk) {
  extern __shared__ float acc[];  // (tile, chunk)
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int ch = blockIdx.y * chunk + threadIdx.x;
  // blockDim.x is chunk rounded up to whole warps; the extra lanes only
  // help read parents
  const bool live = threadIdx.x < chunk && ch < c_run;
  if (live)
    for (int r = 0; r < tile; ++r) acc[r * chunk + threadIdx.x] = 0.f;
  const int lo = t * tile;
  for (int g = 0; g < n_groups; ++g) {
    const int ws = wstart[(int64_t)t * n_groups + g];
    const int end = min(ws + win, cap_in);
    const int32_t* pg = parent_g + (int64_t)g * cap_in;
    for (int r0 = ws; r0 < end; r0 += 32) {
      int pl = -1;
      if (r0 + lane < end) {
        const int p = pg[r0 + lane] - lo;
        if (p >= 0 && p < tile) pl = p;
      }
      unsigned hits = __ballot_sync(0xffffffffu, pl >= 0);
      while (hits) {
        const int j = __ffs(hits) - 1;
        hits &= hits - 1;
        const int p = __shfl_sync(0xffffffffu, pl, j);
        if (live)
          acc[p * chunk + threadIdx.x] +=
              __bfloat162float(pall[(int64_t)(r0 + j) * c_run + ch]);
      }
    }
  }
  if (!live) return;
  for (int r = 0; r < tile; ++r)
    out[(int64_t)(lo + r) * c_run + ch] = acc[r * chunk + threadIdx.x];
}

}  // namespace

// Plain C entry point (loaded with ctypes). ``chunk`` channels per block
// (the block has ``chunk`` threads rounded up to whole warps),
// ``smem_bytes`` = tile * chunk * 4.
// Returns the first CUDA error of the attribute call or the launch.
extern "C" int lgs_csum(const void* wstart, const void* parent_g,
                        const void* pall, void* out, int cap_in, int cap_out,
                        int c_run, int tile, int win, int n_groups, int chunk,
                        int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      csum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cap_out / tile, (c_run + chunk - 1) / chunk);
  const int threads = (chunk + 31) / 32 * 32;
  csum_kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wstart),
      static_cast<const int32_t*>(parent_g),
      static_cast<const __nv_bfloat16*>(pall), static_cast<float*>(out), cap_in,
      c_run, tile, win, n_groups, chunk);
  return static_cast<int>(cudaGetLastError());
}
