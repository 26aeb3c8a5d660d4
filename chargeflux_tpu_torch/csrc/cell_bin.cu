// Cell binning for sm_90a: each atom's slot in its cell, stable by atom id.
// Given int32 cell ids (cell[i] in [0, n_cells); any other id, such as the
// halo route's n_cells for an atom owned by another rank, means "binned
// nowhere"), it writes
//   slots   [n_cells * cap]  the atom id in each slot, sentinel n;
//   slot_of [n]              each atom's flat slot, sentinel n_cells * cap;
//   overflow [1]             the atoms past their cell's capacity,
// the same bits as the plain version (ops/cell_bin.py: a stable sort on the
// cell id and the cell starts by searchsorted).  An atom's rank in its cell
// is the number of lower-id atoms in the same cell; atoms of rank >= cap are
// dropped (slot_of = sentinel) and counted.
//
// Replaces chargeflux_tpu/cells.py:151-270 (rank_into_slots,
// build_cell_list_full: the JAX package's one-hot ranking in XLA, not
// Pallas) and the ownership-masked copy in
// chargeflux_tpu/parallel/halo.py's local binning.
//
// What bounds it on the H100.  Bytes, and far below any rate: at 30k the
// ids in (128 KB), the slots and inverse slots out (308 KB) are 0.1 us at
// 3.35 TB/s, against a few microseconds of launch and synchronization
// latency per pass.  So the design keeps the passes few and short, with no
// host reads (a fixed grid from n and n_cells), so that it captures into a
// CUDA graph: a deterministic counting sort in three launches, no float
// math and no atomic whose result depends on the order of its callers.
//  1. count: one block per chunk of kChunk atoms counts its atoms per cell
//     in shared memory (integer atomics: the sums do not depend on order)
//     and writes counts[cell][chunk]; the blocks also fill the slots with
//     the sentinel, and block 0 zeroes the overflow;
//  2. scan: one warp per cell turns its row of chunk counts into exclusive
//     prefixes (the rank of the chunk's first atom in the cell) and adds the
//     cell's excess over cap to the overflow;
//  3. rank: one block per chunk again; within a warp __match_any_sync finds
//     the lanes of the same cell and the popcount of the lower ones ranks
//     them; the warps then take their per-cell offsets from a shared counter
//     in warp order (one __syncthreads per warp), so the rank counts exactly
//     the lower-id atoms of the chunk.
//
// Prediction, written before the kernel's first timed run (30k: 31,944
// atoms, 512 cells, capacity 88; 32 chunks): three launches of a few us
// each, 0.01-0.03 ms as a graph, against 0.150 ms for the sort-based plain
// version (phases_ms) on an NVIDIA H100 80GB HBM3 at 700.00 W.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;              // atoms per block of passes 1, 3
constexpr int kWarps = kChunk / 32;
constexpr int kScanWarps = 8;             // cells per block of pass 2
constexpr int kMaxCells = 49152;          // shared counters: 192 KiB

__global__ void __launch_bounds__(kChunk)
cell_bin_count_kernel(const int* __restrict__ cell, int n, int n_cells,
                      int cap, int n_chunks, int* __restrict__ counts,
                      int* __restrict__ slots, int* __restrict__ overflow) {
  extern __shared__ int cnt[];
  const int t = threadIdx.x;
  for (int c = t; c < n_cells; c += kChunk) cnt[c] = 0;
  __syncthreads();
  const int i = blockIdx.x * kChunk + t;
  if (i < n) {
    const int c = cell[i];
    if (static_cast<unsigned>(c) < static_cast<unsigned>(n_cells))
      atomicAdd(&cnt[c], 1);
  }
  __syncthreads();
  for (int c = t; c < n_cells; c += kChunk)
    counts[static_cast<long long>(c) * n_chunks + blockIdx.x] = cnt[c];
  const long long n_slots = static_cast<long long>(n_cells) * cap;
  for (long long k = static_cast<long long>(blockIdx.x) * kChunk + t;
       k < n_slots; k += static_cast<long long>(gridDim.x) * kChunk)
    slots[k] = n;
  if (blockIdx.x == 0 && t == 0) *overflow = 0;
}

__global__ void __launch_bounds__(kScanWarps * 32)
cell_bin_scan_kernel(int n_cells, int cap, int n_chunks,
                     int* __restrict__ counts, int* __restrict__ overflow) {
  const int c = blockIdx.x * kScanWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= n_cells) return;
  int* row = counts + static_cast<long long>(c) * n_chunks;
  int carry = 0;
  for (int k0 = 0; k0 < n_chunks; k0 += 32) {
    const int k = k0 + lane;
    const int v = k < n_chunks ? row[k] : 0;
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (k < n_chunks) row[k] = carry + x - v;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0 && carry > cap) atomicAdd(overflow, carry - cap);
}

__global__ void __launch_bounds__(kChunk)
cell_bin_rank_kernel(const int* __restrict__ cell, int n, int n_cells,
                     int cap, int n_chunks, const int* __restrict__ counts,
                     int* __restrict__ slots, int* __restrict__ slot_of) {
  extern __shared__ int cnt[];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  for (int c = t; c < n_cells; c += kChunk) cnt[c] = 0;
  const int i = blockIdx.x * kChunk + t;
  const int c = i < n ? cell[i] : -1;
  const bool mine =
      i < n && static_cast<unsigned>(c) < static_cast<unsigned>(n_cells);
  // the lanes of this warp in the same cell (all lanes binned nowhere share
  // the key -1 and are ignored)
  const unsigned peers = __match_any_sync(0xffffffffu, mine ? c : -1);
  const int below = __popc(peers & ((1u << lane) - 1u));
  const int leader = __ffs(peers) - 1;
  __syncthreads();
  int rank = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {                      // warp-uniform
      const int before = mine ? cnt[c] : 0;
      __syncwarp();
      if (mine && lane == leader) cnt[c] = before + __popc(peers);
      rank = before + below;
    }
    __syncthreads();
  }
  if (i >= n) return;
  int s = n_cells * cap;
  if (mine) {
    rank += counts[static_cast<long long>(c) * n_chunks + blockIdx.x];
    if (rank < cap) {
      s = c * cap + rank;
      slots[s] = i;
    }
  }
  slot_of[i] = s;
}

}  // namespace

extern "C" {

// The most cells the kernels take and the atoms per chunk (the scratch
// `counts` holds n_cells * ceil(n / chunk) ints).
int cf_cell_bin_limits(int* max_cells, int* chunk) {
  *max_cells = kMaxCells;
  *chunk = kChunk;
  return 0;
}

// cell [n] int32; counts [n_cells * n_chunks] int32 scratch with
// n_chunks = max(1, ceil(n / chunk)); outputs slots [n_cells * cap],
// slot_of [n] and overflow [1], all int32.
int cf_cell_bin(const int* cell, int n, int n_cells, int cap, int* counts,
                int* slots, int* slot_of, int* overflow, void* stream) {
  if (n < 0 || n_cells < 1 || n_cells > kMaxCells || cap < 1 ||
      static_cast<long long>(n_cells) * cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = n > 0 ? (n + kChunk - 1) / kChunk : 1;
  const size_t smem = static_cast<size_t>(n_cells) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cell_bin_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(cell_bin_rank_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cell_bin_count_kernel<<<n_chunks, kChunk, smem, s>>>(
      cell, n, n_cells, cap, n_chunks, counts, slots, overflow);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cell_bin_scan_kernel<<<(n_cells + kScanWarps - 1) / kScanWarps,
                         kScanWarps * 32, 0, s>>>(n_cells, cap, n_chunks,
                                                  counts, overflow);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cell_bin_rank_kernel<<<n_chunks, kChunk, smem, s>>>(
      cell, n, n_cells, cap, n_chunks, counts, slots, slot_of);
  return (int)cudaGetLastError();
}

}  // extern "C"
