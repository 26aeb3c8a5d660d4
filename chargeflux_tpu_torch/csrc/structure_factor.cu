// Classical-Ewald structure factors, forward and backward, for sm_90a.
//
// Replaces chargeflux_tpu/ops/pallas_recip.py (make_structure_factor_fn):
//   sf_fwd_kernel                  replaces _fwd_impl / _fwd_kernel
//                                  (pallas_call at :145);
//   sf_bwd_tables_kernel           replaces the _bwd_tables_kernel call of
//                                  _bwd_impl (:157);
//   sf_bwd_zq_kernel               replaces its _bwd_zq_kernel call (:172).
// Same contract as there, without the TPU padding: per-axis phase tables
//   cxT, sxT [Kx, N]    cos/sin(2 pi f_x n_x)
//   cyT, syT [Ky, N]    cos/sin(2 pi f_y n_y)
//   zq       [N, 2Kz]   q * [cos_z | sin_z]
// and, with cxy[(kx,ky), n] = cx cy - sx sy, sxy[(kx,ky), n] = sx cy + cx sy,
//   A = cxy @ zq,  B = sxy @ zq                      [Kx*Ky, 2Kz]
//   gc = Abar zq^T, gs = Bbar zq^T per (kx, ky, n)
//   dcx = sum_ky gc cy + gs sy     dsx = sum_ky gs cy - gc sy
//   dcy = sum_kx gc cx + gs sx     dsy = sum_kx gs cx - gc sx
//   dzq = cxy^T Abar + sxy^T Bbar                    [N, 2Kz]
// Each contraction is 2 * Kx*Ky * N * 2Kz multiply-adds: 3.1 M at the
// 216-water path (Kx 7, Ky 13, 2Kz 26, N 648), 130 M at a 4k box with kmax
// 13^3 (Kx 13, Ky 25, 2Kz 50, N 3993) — 0.1 and 4 us of the card's f32 FMA
// issue rate.  The inputs are < 1.5 MB, all in the 50 MB L2.  The engine
// stays bitwise reproducible: no float atomics, every output has one writer
// or a fixed-order reduction, so two launches give equal bits.  f32 FMA on
// the CUDA cores only: TF32 would be the twin of the TPU bf16 demotion.
//
// Forward, as first written: one block per (kx, chunk of 64 atoms), a
// thread one (ky, c) output at a time over the chunk (a dependent chain of
// 2 FMAs with 3 scalar shared loads per atom), the per-chunk partials
// [2, N/64, Kx*Ky, 2Kz] (8 MB at 4k) summed by a second kernel: 0.0076 ms
// at 216, 0.0395 at 4k, 1.9x behind one matmul there.
//
// Forward, now: one launch, no scratch.  A skinny GEMM with a long K (the
// atoms), so the split is over K.  The grid is (kx, ky group, atom split),
// launched as thread block clusters of the splits of one tile.  A block
// owns the output tile [y_rows, 2Kz] of one kx for both A and B and sums
// it over the atoms of its split in registers, chunk after chunk of
// kFwdChunk atoms in order; there is no per-chunk partial.  The chunk's
// cx/sx (one row), cy/sy (the tile's rows) and zq rows land in shared
// memory by cp.async (16-byte copies of the tables where N and the
// pointers allow, 8-byte pairs of zq where 2Kz is even; narrower
// otherwise), double-buffered: chunk i+1 is in flight while chunk i is
// formed into (cxy, sxy) pairs [atom][2 y_rows] and consumed.  A thread
// owns 2 ky rows x 4 columns of A and of B, 16 independent accumulators,
// and reads one float4 of (cxy, sxy) pairs and one float4 of zq per atom,
// four atoms' operands before the first FMA: 2 vector loads per 16 FMAs.
// zq rows are padded to ceil4(2Kz) columns, zero, in shared memory only.
// Where a tile has fewer micro-tiles than the block may have threads,
// j_split threads share each: thread js sums the atoms js, js + j_split,
// ... of every chunk, and the threads' sums are added in js order through
// shared memory.  At the end every block of the cluster holds its split's
// tile in its shared memory; after a cluster barrier each block folds a
// share of the tile's float4s, reading all blocks' copies through
// distributed shared memory in rank order s = 0 .. S-1, and writes A and
// B.  So there is no partial in global memory, no fence, no counter and no
// float atomic, and a CUDA graph can replay the launch as it is.
// The plan (ky rows per block, j_split, S <= 8 and the atoms per split)
// comes from the shapes alone (ops/structure_factor.py, plan_forward: a
// fixed block target and the constants below, which cf_sf_limits hands
// it), never from the card, so the bits are the same on any card.
// -Xptxas -v: 61 registers, no spills.  Launches (block target 132):
//   216 (Kx 7, Ky 13, 2Kz 26, N 648): 6 rows x 3 groups, j_split 12, 8
//        splits of 84 atoms: 168 blocks of 256 threads, 49,152 B of
//        shared memory, one chunk each; ~10 warps per SM.
//   4k (13, 25, 50, 3993): 14 rows x 2 groups, j_split 2, 8 splits of 500:
//        208 blocks of 192 threads, 98,304 B, 4 chunks each; ~9 warps per
//        SM.
//   the limits (Kx 4, Ky 63, 2Kz 126, N 1000): 14 rows x 5 groups, 8 splits
//        of 128: 160 blocks of 224 threads, 176,128 B (one block per SM).
// Measured (H100 80GB HBM3 at 700 W, CUDA graphs of 20 calls): 0.0063 ms
// at 216 (one matmul 0.0083), 0.0327 at 4k (matmul 0.0206).  Predicted
// 0.004-0.006 and 0.012-0.022.  One-off builds with parts cut out (not
// kept in this source), 216 / 4k: launch and prologue alone 0.0024 /
// 0.0030, + the copies 0.0033 / 0.0126, + the forming 0.0036 / 0.0164, + the FMA loop 0.0042 / 0.0298, + the two sums 0.0064
// / 0.0327; with N 3992 (16-byte table copies, not 4-byte) the copies
// take 0.0061 of 4k's 0.0096.  At 216 it is the latency of one chunk
// behind a launch.  At 4k no one part bounds it: the copies (cp.async,
// which the load/store unit handles lane by lane), the forming, the shared
// loads and the FMAs run one after the other in a block, and at 1-2
// blocks of 6 warps per SM nothing overlaps them; 512 or 1024 threads a
// block, 4-row micro-tiles and 2 or 8 atoms a batch changed nothing.
// What would: the contiguous zq span and row-aligned table spans by bulk
// (TMA) copies from a producer warp, and a 4 x 8 micro-tile (half the
// shared loads per FMA) with more chunks in flight.  Earlier variants of
// this redesign, in order: partials in global memory folded by the tile's
// last block after an integer ticket, a thread folding one output at a
// time, took 0.0160 / 0.0575 ms (the fold's dependent L2 round trips); the
// same with float4 folds, eight loads in flight, 0.0082 / 0.0327; the
// cluster fold with j_split 0.0068 / 0.0355; then batched operand loads
// and chunks of 128 atoms for the figures above.
//
// Backward, as first written: one thread per atom, 64 per block, Abar/Bbar
// streamed one kx slab [Ky, 2Kz] at a time through shared memory.  At 4k
// that was 63 blocks of 2 warps for 132 SMs of 64 warp slots (< 2 %
// occupied), each thread one dependent FMA chain per output: Kx*2Kz*2Ky =
// 32,500 deep for dzq, 16,250 for gc/gs.  0.23-0.29 ms at 4k, ~16 cycles
// per FMA: latency, with nothing to hide it.
//
// Backward, now: two small GEMMs whose left operand is made on the fly
// from the per-axis tables, one block per tile of 16 atoms, every output
// column or ky row of the tile in the block.  The K loop runs over kx
// slabs: the Abar/Bbar rows of one kx, [Ky, 2Kz] each, and cx/sx of that
// kx for the tile land in shared memory by cp.async (8-byte pairs where
// 2Kz is even and the rows aligned, as the engine's always are; single
// floats otherwise), double-buffered, so slab kx+1 loads while slab kx is
// consumed; the rows are padded to ceil4(2Kz) columns (and the tables
// kernel's to a whole row group), zero, in shared memory only.  The tile's
// zq rows (tables) or cy/sy columns (zq) join slab 0's copy group.  Each
// thread owns a register micro-tile:
//   sf_bwd_zq_kernel: dzq [N, 2Kz] = [cxy^T | sxy^T] [Abar ; Bbar], K =
//     2 Kx Ky.  Per slab the block forms cxy/sxy [Ky, 16] in shared memory
//     from the slab's cx/sx and the staged cy/sy; a thread owns 2 atoms x
//     2 columns (4 independent accumulators, float2 shared loads), each
//     summed per kx and then over kx, as the one-thread-per-atom design did.
//   sf_bwd_tables_kernel: per slab G = [Abar ; Bbar] zq^T, K = 2Kz, over
//     the staged zq tile; a thread owns 2 ky rows x 1 atom of gc and gs
//     and runs the epilogue: dcy/dsy accumulate in registers across kx, in
//     kx order; dcx/dsx are summed over the thread's rows, then over the
//     row groups through shared memory in group order.
// No split over kx: it would need a partials buffer and a second pass.
// The atom tile is the split: 16 puts a block on every SM at 4k and keeps
// the per-block reload of the slabs (blocks x 130 KB from L2 at 4k) below
// the FMA time.  -Xptxas -v: tables 60 registers, zq 48, no spills.
//   216 (Kx 7, Ky 13, 2Kz 26, N 648): 41 blocks of 112 threads; shared
//        memory 9,216 B (tables), 9,408 B (zq).
//   4k (13, 25, 50, 3993): 250 blocks of 208 threads; 26,880 B, 27,456 B.
// Tensor cores (3xTF32 mma.sync) are not used: the FMA loop is about half
// of the time (below), and a hi/lo split would need its force error and
// bitwise repeat measured first.
//
// The prediction written before the first chip run (of a 4-row x 2-atom /
// 2-atom x 4-column tiling with cx/sx read from global memory): per SM at
// 4k, 2 blocks (8 warps zq, 4 warps tables) with 8-16 independent
// accumulators per thread, about 8.5k (zq) and 17k (tables) issue slots per
// warp, shared loads at one per 4-5 FMAs, plus 2 block barriers per kx and
// the cp.async issue (4-byte copies, 24-45 per thread per slab).  Predicted
// CUDA-event time per call on the H100: 4k zq 0.012-0.025 ms, tables
// 0.015-0.030 ms; 216 each 0.006-0.015 ms, where the launch and the first
// slab's latency are most of it.
// Measured (H100 80GB HBM3 at 700 W, CUDA graphs of 20 calls, zq /
// tables): that tiling took 0.033 / 0.046 ms at 4k and 0.011 / 0.018 at
// 216; with cx/sx moved into the slab copies, 0.031 / 0.039 at 4k.  Of
// that, launch and prologue alone took 0.008 / 0.011 ms, the FMA loop
// 0.012 / 0.019 and the slab copies most of the rest; dropping the in-loop
// barriers changed nothing.  So the prologue's serial global loads and the
// 4-byte copy issue went into cp.async groups of pairs, and a sweep of
// tilings picked the thinner micro-tiles above (more warps per SM): 0.027
// / 0.031 ms at 4k, 0.007 / 0.009 at 216.  What bounds it now is latency
// in a short kernel: 13 slabs per block, a few warps per scheduler, the
// FMA loop at 3-4x its issue time, and ~0.008 ms of launch and prologue.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace coop = cooperative_groups;

constexpr int kMaxKy = 64;      // Ky = 2 kmax_y - 1 bound (kmax_y <= 32)
constexpr int kMaxKz2 = 128;    // 2Kz = 2 (2 kmax_z - 1) bound (kmax_z <= 32)
constexpr int kFwdChunk = 128;  // atoms per staged forward chunk
constexpr int kFwdThreads = 256;     // most threads of a forward block
constexpr int kFwdMaxSplits = 8;     // blocks of a cluster (the portable most)
constexpr int kFwdMaxRows = 32;      // most ky rows of a block's tile
// ky rows (an even count) x columns of A and of B per thread
constexpr int kFwdRows = 2, kFwdCols = 4;
constexpr int kFwdMaxJSplit = 16;    // most threads that share a micro-tile
constexpr int kFwdBatch = 4;         // atoms whose operands load together
constexpr int kTile = 16;       // atoms per backward block
constexpr int kRows = 2;        // ky rows of one atom per tables thread
constexpr int kZqPer = 2, kZqCols = 2;  // atoms x dzq columns per zq thread

__host__ __device__ constexpr int ceil4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// W consecutive floats (both sides 4 W-byte aligned) as one copy.
template <int W>
__device__ __forceinline__ void cp_async_w(float* dst, const float* src) {
  if constexpr (W == 4) cp_async16(dst, src);
  else if constexpr (W == 2) cp_async8(dst, src);
  else cp_async4(dst, src);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// N consecutive floats of shared memory (N-aligned) as one access.
template <int N> struct Vec;
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  const typename Vec<N>::T v = *reinterpret_cast<const typename Vec<N>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = f[i];
}

// Where a thread starts and how it steps through a [rows, cols] array in
// row order, blockDim.x elements at a time, without a division per element.
struct Stride2d {
  int y, c, dy, dc, cols;
};

__device__ __forceinline__ Stride2d make_stride(int cols) {
  return {(int)threadIdx.x / cols, (int)threadIdx.x % cols,
          (int)blockDim.x / cols, (int)blockDim.x % cols, cols};
}

// f(y, c) for the elements threadIdx.x, + blockDim.x, ... of the first
// ``rows`` rows.
template <typename F>
__device__ __forceinline__ void for_strided(Stride2d st, int rows, F f) {
  for (int y = st.y, c = st.c; y < rows;) {
    f(y, c);
    y += st.dy;
    c += st.dc;
    if (c >= st.cols) {
      c -= st.cols;
      ++y;
    }
  }
}

template <typename F>
__device__ __forceinline__ void strided_2d(int rows, int cols, F f) {
  for_strided(make_stride(cols), rows, f);
}

// Shared memory of the forward kernel, in floats.  While the chunks run:
// two chunk stages, each cx, sx [kFwdChunk], cy then sy
// [y_rows][kFwdChunk] and zq [kFwdChunk][kzp]; then the formed (cxy, sxy)
// pairs [kFwdChunk][pair_w].  After them, over the same memory: the block's
// tile [2][y_rows][kzp], then its threads' accumulators [4][threads] float4.
struct FwdSmem {
  int y_rows, kzp, j_split;
  __host__ __device__ int owners() const {
    return y_rows / kFwdRows * (kzp / kFwdCols);
  }
  // 2 y_rows floats a row, padded to an odd count of float4: the lanes of a
  // warp (one atom each) store their pair two to a bank, not y_rows / 2
  __host__ __device__ int pair_w() const { return 4 * ((y_rows / 2) | 1); }
  __host__ __device__ int ys() const { return 2 * kFwdChunk; }
  __host__ __device__ int zs() const { return ys() + 2 * y_rows * kFwdChunk; }
  __host__ __device__ int stage() const { return zs() + kFwdChunk * kzp; }
  __host__ __device__ int tile() const { return 2 * y_rows * kzp; }
  __host__ __device__ int floats() const {
    const int chunks = 2 * stage() + kFwdChunk * pair_w();
    const int sums = tile() + 2 * kFwdRows * kFwdCols * owners() * j_split;
    return chunks > sums ? chunks : sums;
  }
};

// ``rows`` table rows of the chunk's cnt atoms, src rows ``stride`` apart,
// into rows of kFwdChunk floats, W floats a copy (cnt is a multiple of W).
template <int W>
__device__ __forceinline__ void copy_table_rows(float* dst, const float* src,
                                                size_t stride, int rows,
                                                int cnt) {
  constexpr int kVecs = kFwdChunk / W;
  for (int i = threadIdx.x; i < rows * kVecs; i += blockDim.x) {
    const int r = i / kVecs, j = i % kVecs * W;
    if (j < cnt)
      cp_async_w<W>(dst + r * kFwdChunk + j, src + (size_t)r * stride + j);
  }
}

// The tables of one forward chunk: cx/sx of kx = x and the tile's ``rows``
// cy/sy rows from y0, for the cnt atoms from n0.
template <int W>
__device__ __forceinline__ void load_fwd_tables(
    float* st, FwdSmem sm, const float* __restrict__ cxT,
    const float* __restrict__ sxT, const float* __restrict__ cyT,
    const float* __restrict__ syT, int x, int y0, int rows, int n, int n0,
    int cnt) {
  const size_t xo = (size_t)x * n + n0, yo = (size_t)y0 * n + n0;
  copy_table_rows<W>(st, cxT + xo, 0, 1, cnt);
  copy_table_rows<W>(st + kFwdChunk, sxT + xo, 0, 1, cnt);
  copy_table_rows<W>(st + sm.ys(), cyT + yo, n, rows, cnt);
  copy_table_rows<W>(st + sm.ys() + sm.y_rows * kFwdChunk, syT + yo, n, rows,
                     cnt);
}

// Start the copy of one forward chunk into the stage at st, as one cp.async
// group.  wt, wz: floats per copy of the tables and of zq (copy_width);
// zst: make_stride(kz2 / wz), made once.
__device__ __forceinline__ void load_fwd_chunk(
    float* st, FwdSmem sm, const float* __restrict__ cxT,
    const float* __restrict__ sxT, const float* __restrict__ cyT,
    const float* __restrict__ syT, const float* __restrict__ zq, int x,
    int y0, int rows, int kz2, int n, int n0, int cnt, int wt, int wz,
    Stride2d zst) {
  if (wt == 4)
    load_fwd_tables<4>(st, sm, cxT, sxT, cyT, syT, x, y0, rows, n, n0, cnt);
  else if (wt == 2)
    load_fwd_tables<2>(st, sm, cxT, sxT, cyT, syT, x, y0, rows, n, n0, cnt);
  else
    load_fwd_tables<1>(st, sm, cxT, sxT, cyT, syT, x, y0, rows, n, n0, cnt);
  float* zs = st + sm.zs();
  const float* src = zq + (size_t)n0 * kz2;
  if (wz == 2)
    for_strided(zst, cnt, [&](int j, int h) {
      cp_async8(zs + j * sm.kzp + 2 * h, src + (size_t)j * kz2 + 2 * h);
    });
  else
    for_strided(zst, cnt, [&](int j, int c) {
      cp_async4(zs + j * sm.kzp + c, src + (size_t)j * kz2 + c);
    });
  cp_async_commit();
}

// One atom's terms of a micro-tile: cs holds (cxy, sxy) of its rows, two
// rows a float4; zv its zq columns.
__device__ __forceinline__ void fwd_fma(const float (&cs)[kFwdRows / 2][4],
                                        const float (&zv)[kFwdCols],
                                        float (&a)[kFwdRows][kFwdCols],
                                        float (&b)[kFwdRows][kFwdCols]) {
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
    for (int k = 0; k < kFwdCols; ++k) {
      a[r][k] = fmaf(cs[r / 2][2 * (r % 2)], zv[k], a[r][k]);
      b[r][k] = fmaf(cs[r / 2][2 * (r % 2) + 1], zv[k], b[r][k]);
    }
}

// Grid (R x kx, ky groups of y_rows rows, n_splits atom ranges of
// split_len), launched as clusters of the n_splits blocks of one tile.  The
// replica index r = blockIdx.x / kx only moves the pointers, by the
// replica strides (in floats) of the x tables, the y tables, zq and A/B, so
// each replica's slice of a batched launch is the single-system launch on
// that replica, bit for bit.  A block's
// owners() micro-tiles are each held by j_split threads, thread js of them
// summing the atoms js, js + j_split, ... of every chunk.
__global__ void __launch_bounds__(kFwdThreads)
sf_fwd_kernel(const float* __restrict__ cxT, const float* __restrict__ sxT,
              const float* __restrict__ cyT, const float* __restrict__ syT,
              const float* __restrict__ zq, float* __restrict__ a_out,
              float* __restrict__ b_out, int kx, int ky, int kz2, int n,
              int y_rows, int j_split, int split_len, int wt, int wz,
              long long s_x, long long s_y, long long s_z, long long s_ab) {
  extern __shared__ __align__(16) float fwd_smem[];
  coop::cluster_group cluster = coop::this_cluster();
  {
    const long long r = blockIdx.x / kx;
    cxT += r * s_x;
    sxT += r * s_x;
    cyT += r * s_y;
    syT += r * s_y;
    zq += r * s_z;
    a_out += r * s_ab;
    b_out += r * s_ab;
  }
  const int kzp = ceil4(kz2);
  const FwdSmem sm{y_rows, kzp, j_split};
  const int pair_w = sm.pair_w();
  float* pairs = fwd_smem + 2 * sm.stage();  // [kFwdChunk][pair_w]
  const int t = threadIdx.x;
  const int x = blockIdx.x % kx;
  const int y0 = blockIdx.y * y_rows;
  const int rows = min(y_rows, ky - y0);     // the tile's real rows
  const int col_groups = kzp / kFwdCols;
  const int owners = sm.owners();
  const int n_live = owners * j_split;       // threads with a micro-tile
  const int js = t / owners, own = t % owners;
  const int rg = own / col_groups, cg = own % col_groups;
  const bool live = t < n_live;
  const int lo = blockIdx.z * split_len;
  const int hi = min(n, lo + split_len);
  const int n_chunks = (hi - lo + kFwdChunk - 1) / kFwdChunk;
  const Stride2d zst = make_stride(kz2 / wz);

  // what no copy and no forming writes: the pair rows past ``rows`` and
  // the zq columns past kz2 of both stages
  for (int i = t; i < kFwdChunk * pair_w; i += blockDim.x) pairs[i] = 0.0f;
  for (int i = t; i < 2 * kFwdChunk; i += blockDim.x) {
    float* row = fwd_smem + i / kFwdChunk * sm.stage() + sm.zs() +
                 i % kFwdChunk * kzp;
    for (int c = kz2; c < kzp; ++c) row[c] = 0.0f;
  }

  float a[kFwdRows][kFwdCols] = {}, b[kFwdRows][kFwdCols] = {};
  load_fwd_chunk(fwd_smem, sm, cxT, sxT, cyT, syT, zq, x, y0, rows, kz2, n,
                 lo, min(kFwdChunk, hi - lo), wt, wz, zst);
  for (int i = 0; i < n_chunks; ++i) {
    const int n0 = lo + i * kFwdChunk;
    const int cnt = min(kFwdChunk, hi - n0);
    // chunk i has landed; every thread is past chunk i - 1
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < n_chunks)
      load_fwd_chunk(fwd_smem + ((i + 1) & 1) * sm.stage(), sm, cxT, sxT,
                     cyT, syT, zq, x, y0, rows, kz2, n, n0 + kFwdChunk,
                     min(kFwdChunk, hi - n0 - kFwdChunk), wt, wz, zst);
    const float* st = fwd_smem + (i & 1) * sm.stage();
    const float* ys = st + sm.ys();
    for (int e = t; e < rows * kFwdChunk; e += blockDim.x) {
      const int y = e / kFwdChunk, j = e % kFwdChunk;
      if (j < cnt) {
        const float cx = st[j], sx = st[kFwdChunk + j];
        const float cy = ys[y * kFwdChunk + j];
        const float sy = ys[(y_rows + y) * kFwdChunk + j];
        *reinterpret_cast<float2*>(pairs + j * pair_w + 2 * y) =
            make_float2(cx * cy - sx * sy, sx * cy + cx * sy);
      }
    }
    __syncthreads();
    if (live) {
      const float* pr = pairs + 2 * kFwdRows * rg;
      const float* zr = st + sm.zs() + kFwdCols * cg;
      // kFwdBatch atoms a turn, their operands loaded before the first
      // FMA needs one (a branch per atom would put each load's latency in
      // front of its 16 FMAs)
      int j = js;
      for (; j + (kFwdBatch - 1) * j_split < cnt; j += kFwdBatch * j_split) {
        float cs[kFwdBatch][kFwdRows / 2][4], zv[kFwdBatch][kFwdCols];
#pragma unroll
        for (int u = 0; u < kFwdBatch; ++u) {
          const int ju = j + u * j_split;
#pragma unroll
          for (int h = 0; h < kFwdRows / 2; ++h)
            load_vec(pr + ju * pair_w + 4 * h, cs[u][h]);
          load_vec(zr + ju * kzp, zv[u]);
        }
#pragma unroll
        for (int u = 0; u < kFwdBatch; ++u)
          fwd_fma(cs[u], zv[u], a, b);
      }
      for (; j < cnt; j += j_split) {
        float cs[kFwdRows / 2][4], zv[kFwdCols];  // (c, s) of two rows each
#pragma unroll
        for (int h = 0; h < kFwdRows / 2; ++h)
          load_vec(pr + j * pair_w + 4 * h, cs[h]);
        load_vec(zr + j * kzp, zv);
        fwd_fma(cs, zv, a, b);
      }
    }
  }

  // The block's tile [2][y_rows][kzp] (A rows, then B rows): each
  // micro-tile row summed over its j_split threads in js order.  The
  // accumulators of pad rows and columns are zero.
  float* tile = fwd_smem;
  float4* sums = reinterpret_cast<float4*>(fwd_smem + sm.tile());
  __syncthreads();  // every thread is past the stages
  if (live) {
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) {
      sums[(2 * r) * n_live + t] =
          make_float4(a[r][0], a[r][1], a[r][2], a[r][3]);
      sums[(2 * r + 1) * n_live + t] =
          make_float4(b[r][0], b[r][1], b[r][2], b[r][3]);
    }
  }
  __syncthreads();
  for (int i = t; i < 2 * kFwdRows * owners; i += blockDim.x) {
    const int q = i / owners, o = i % owners;  // q = 2 r + (0 for A, 1 for B)
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < j_split; ++k) {
      const float4 u = sums[q * n_live + k * owners + o];
      acc.x += u.x;
      acc.y += u.y;
      acc.z += u.z;
      acc.w += u.w;
    }
    const int row = (q & 1) * y_rows + kFwdRows * (o / col_groups) + (q >> 1);
    *reinterpret_cast<float4*>(tile + row * kzp +
                               kFwdCols * (o % col_groups)) = acc;
  }

  // The cluster's blocks hold the tile's n_splits partial sums in their
  // shared memory.  Each folds a share of the tile's float4s, reading all
  // blocks' in rank order s = 0 .. n_splits - 1, and writes A and B.
  cluster.sync();
  const int n_splits = gridDim.z;
  const size_t slab = (size_t)ky * kz2;      // A or B of one kx
  for (int v = blockIdx.z * blockDim.x + t; v < 2 * y_rows * col_groups;
       v += n_splits * blockDim.x) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int k = 0; k < n_splits; ++k) {
      const float4 u = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(tile, k))[v];
      acc.x += u.x;
      acc.y += u.y;
      acc.z += u.z;
      acc.w += u.w;
    }
    const int y = v / col_groups % y_rows, c0 = v % col_groups * kFwdCols;
    if (y >= rows) continue;
    float* out = (v < y_rows * col_groups ? a_out : b_out) + x * slab +
                 (size_t)(y0 + y) * kz2 + c0;
    const float vals[kFwdCols] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int k = 0; k < kFwdCols; ++k)
      if (c0 + k < kz2) out[k] = vals[k];
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// Shared memory of one kx slab buffer: Abar, Bbar [rows][kzp], then the
// tile's cx, sx [kTile].
struct Slab {
  int rows, kzp;
  __host__ __device__ int floats() const { return 2 * rows * kzp + 2 * kTile; }
};

// Zero what cp.async never writes in the two slab buffers at ab: columns
// kz2.. and rows ky.. of Abar/Bbar, and cx/sx past the tile's cnt atoms.
__device__ __forceinline__ void zero_slab_padding(float* ab, Slab sl, int ky,
                                                  int kz2, int cnt) {
  for (int k = 0; k < 2; ++k) {
    float* buf = ab + k * sl.floats();
    if (sl.kzp > kz2)
      strided_2d(2 * sl.rows, sl.kzp - kz2,
                 [&](int r, int c) { buf[r * sl.kzp + kz2 + c] = 0.0f; });
    for (int m = 0; m < 2; ++m)
      strided_2d(sl.rows - ky, sl.kzp, [&](int r, int c) {
        buf[(m * sl.rows + ky + r) * sl.kzp + c] = 0.0f;
      });
    float* xs = buf + 2 * sl.rows * sl.kzp;
    for (int j = cnt + threadIdx.x; j < kTile; j += blockDim.x)
      xs[j] = xs[kTile + j] = 0.0f;
  }
}

// Start the copy of slab x into the buffer at buf, as one cp.async group
// (with whatever the caller issued since the last group): the Abar/Bbar
// rows of kx = x ([ky][kz2] each) and cx/sx of kx for the tile's cnt atoms
// from n0.  pairs: 2Kz is even and abar/bbar 8-byte aligned, so every row
// copies as 8-byte pairs.
__device__ __forceinline__ void load_slab(float* buf, Slab sl,
                                          const float* __restrict__ abar,
                                          const float* __restrict__ bbar,
                                          const float* __restrict__ cxT,
                                          const float* __restrict__ sxT,
                                          int x, int ky, int kz2, int n,
                                          int n0, int cnt, bool pairs) {
  float* a = buf;
  float* b = buf + sl.rows * sl.kzp;
  float* xs = buf + 2 * sl.rows * sl.kzp;
  const size_t g = (size_t)x * ky * kz2;
  if (pairs) {
    strided_2d(ky, kz2 / 2, [&](int y, int h) {
      const size_t src = g + (size_t)y * kz2 + 2 * h;
      cp_async8(a + y * sl.kzp + 2 * h, abar + src);
      cp_async8(b + y * sl.kzp + 2 * h, bbar + src);
    });
  } else {
    strided_2d(ky, kz2, [&](int y, int c) {
      const size_t src = g + (size_t)y * kz2 + c;
      cp_async4(a + y * sl.kzp + c, abar + src);
      cp_async4(b + y * sl.kzp + c, bbar + src);
    });
  }
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    cp_async4(xs + j, cxT + (size_t)x * n + n0 + j);
    cp_async4(xs + kTile + j, sxT + (size_t)x * n + n0 + j);
  }
  cp_async_commit();
}

// Each thread owns kRows ky rows of one atom.
__global__ void sf_bwd_tables_kernel(
    const float* __restrict__ cxT, const float* __restrict__ sxT,
    const float* __restrict__ cyT, const float* __restrict__ syT,
    const float* __restrict__ zq, const float* __restrict__ abar,
    const float* __restrict__ bbar, float* __restrict__ dcx,
    float* __restrict__ dsx, float* __restrict__ dcy,
    float* __restrict__ dsy, int kx, int ky, int kz2, int n, bool pairs,
    long long s_x, long long s_y, long long s_z, long long s_ab) {
  extern __shared__ __align__(16) float bwd_smem[];
  {  // the replica (blockIdx.y) picks the data only
    const long long r = blockIdx.y;
    cxT += r * s_x;
    sxT += r * s_x;
    dcx += r * s_x;
    dsx += r * s_x;
    cyT += r * s_y;
    syT += r * s_y;
    dcy += r * s_y;
    dsy += r * s_y;
    zq += r * s_z;
    abar += r * s_ab;
    bbar += r * s_ab;
  }
  const int kzp = ceil4(kz2);
  const int kyp = (ky + kRows - 1) / kRows * kRows;
  const int groups = kyp / kRows;     // row groups
  const Slab sl{kyp, kzp};
  float* ab = bwd_smem;               // 2 slab buffers
  float* zs = ab + 2 * sl.floats();   // [kzp][kTile] zq of the block's atoms
  float* red = zs + kzp * kTile;      // [2][groups][kTile] dcx/dsx partials
  const int t = threadIdx.x;
  const int j = t % kTile;            // the thread's atom in the tile
  const int rg = t / kTile;           // its ky rows rg*kRows ..
  const int n0 = blockIdx.x * kTile;
  const int cnt = min(kTile, n - n0);

  zero_slab_padding(ab, sl, ky, kz2, cnt);
  // the block's zq rows (one contiguous span) join slab 0's copy group
  strided_2d(kTile, kzp, [&](int a, int c) {
    if (a < cnt && c < kz2)
      cp_async4(zs + c * kTile + a, zq + (size_t)(n0 + a) * kz2 + c);
    else
      zs[c * kTile + a] = 0.0f;
  });
  float cy[kRows], sy[kRows], dcy_acc[kRows] = {}, dsy_acc[kRows] = {};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = rg * kRows + r;
    const bool live = y < ky && j < cnt;
    cy[r] = live ? cyT[(size_t)y * n + n0 + j] : 0.0f;
    sy[r] = live ? syT[(size_t)y * n + n0 + j] : 0.0f;
  }

  load_slab(ab, sl, abar, bbar, cxT, sxT, 0, ky, kz2, n, n0, cnt, pairs);
  for (int x = 0; x < kx; ++x) {
    // slab x has landed; every thread is past kx - 1 (compute and reduce)
    cp_async_wait_all();
    __syncthreads();
    if (x + 1 < kx)
      load_slab(ab + ((x + 1) & 1) * sl.floats(), sl, abar, bbar, cxT, sxT,
                x + 1, ky, kz2, n, n0, cnt, pairs);
    const float* buf = ab + (x & 1) * sl.floats();
    const float* ar = buf + rg * kRows * kzp;
    const float* br = ar + kyp * kzp;
    const float* xs = buf + 2 * kyp * kzp;
    float gc[kRows] = {}, gs[kRows] = {};
#pragma unroll 2
    for (int c = 0; c < kzp; c += 4) {
      float av[kRows][4], bv[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        load_vec(ar + r * kzp + c, av[r]);
        load_vec(br + r * kzp + c, bv[r]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float z = zs[(c + k) * kTile + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          gc[r] = fmaf(av[r][k], z, gc[r]);
          gs[r] = fmaf(bv[r][k], z, gs[r]);
        }
      }
    }
    // epilogue: this kx's dcy/dsy terms, and dcx/dsx over the thread's rows
    const float cx = xs[j], sx = xs[kTile + j];
    float pc = 0.0f, ps = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      pc += gc[r] * cy[r] + gs[r] * sy[r];
      ps += gs[r] * cy[r] - gc[r] * sy[r];
      dcy_acc[r] += gc[r] * cx + gs[r] * sx;
      dsy_acc[r] += gs[r] * cx - gc[r] * sx;
    }
    red[rg * kTile + j] = pc;
    red[(groups + rg) * kTile + j] = ps;
    __syncthreads();
    // dcx/dsx of this kx: the row groups' partials summed in group order
    for (int o = t; o < 2 * kTile; o += blockDim.x) {
      const int w = o / kTile, a = o % kTile;
      const float* p = red + w * groups * kTile + a;
      float sum = 0.0f;
      for (int g = 0; g < groups; ++g) sum += p[g * kTile];
      if (a < cnt) (w ? dsx : dcx)[(size_t)x * n + n0 + a] = sum;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = rg * kRows + r;
    if (y < ky && j < cnt) {
      dcy[(size_t)y * n + n0 + j] = dcy_acc[r];
      dsy[(size_t)y * n + n0 + j] = dsy_acc[r];
    }
  }
}

// Each thread owns kZqPer atoms x kZqCols dzq columns.
__global__ void sf_bwd_zq_kernel(
    const float* __restrict__ cxT, const float* __restrict__ sxT,
    const float* __restrict__ cyT, const float* __restrict__ syT,
    const float* __restrict__ abar, const float* __restrict__ bbar,
    float* __restrict__ dzq, int kx, int ky, int kz2, int n, bool pairs,
    long long s_x, long long s_y, long long s_z, long long s_ab) {
  extern __shared__ __align__(16) float bwd_smem[];
  {  // the replica (blockIdx.y) picks the data only
    const long long r = blockIdx.y;
    cxT += r * s_x;
    sxT += r * s_x;
    cyT += r * s_y;
    syT += r * s_y;
    abar += r * s_ab;
    bbar += r * s_ab;
    dzq += r * s_z;
  }
  constexpr int kGroups = kTile / kZqPer;  // atom groups
  const int kzp = ceil4(kz2);
  const Slab sl{ky, kzp};
  float* ab = bwd_smem;               // 2 slab buffers
  float* cys = ab + 2 * sl.floats();  // [ky][kTile] cy of the block's atoms
  float* sys = cys + ky * kTile;      // [ky][kTile] sy
  float* cxy = sys + ky * kTile;      // [ky][kTile] cxy of the current kx
  float* sxy = cxy + ky * kTile;      // [ky][kTile] sxy
  const int t = threadIdx.x;
  const int ag = t % kGroups;         // atoms ag*kZqPer .. of the tile
  const int col = t / kGroups * kZqCols;  // dzq columns col ..
  const int n0 = blockIdx.x * kTile;
  const int cnt = min(kTile, n - n0);

  zero_slab_padding(ab, sl, ky, kz2, cnt);
  // the tile's cy/sy columns join slab 0's copy group
  strided_2d(ky, kTile, [&](int y, int j) {
    if (j < cnt) {
      cp_async4(cys + y * kTile + j, cyT + (size_t)y * n + n0 + j);
      cp_async4(sys + y * kTile + j, syT + (size_t)y * n + n0 + j);
    } else {
      cys[y * kTile + j] = sys[y * kTile + j] = 0.0f;
    }
  });

  float acc[kZqPer][kZqCols] = {};
  load_slab(ab, sl, abar, bbar, cxT, sxT, 0, ky, kz2, n, n0, cnt, pairs);
  for (int x = 0; x < kx; ++x) {
    // slab x has landed; every thread is past kx - 1
    cp_async_wait_all();
    __syncthreads();
    if (x + 1 < kx)
      load_slab(ab + ((x + 1) & 1) * sl.floats(), sl, abar, bbar, cxT, sxT,
                x + 1, ky, kz2, n, n0, cnt, pairs);
    const float* buf = ab + (x & 1) * sl.floats();
    const float* xs = buf + 2 * ky * kzp;
    strided_2d(ky, kTile, [&](int y, int j) {
      const float cx = xs[j], sx = xs[kTile + j];
      const float cy = cys[y * kTile + j], sy = sys[y * kTile + j];
      cxy[y * kTile + j] = cx * cy - sx * sy;
      sxy[y * kTile + j] = sx * cy + cx * sy;
    });
    __syncthreads();
    const float* ar = buf + col;
    const float* br = ar + ky * kzp;
    // this kx's terms summed apart: chains of 2Ky, not 2 Kx Ky
    float part[kZqPer][kZqCols] = {};
#pragma unroll 4
    for (int y = 0; y < ky; ++y) {
      float cv[kZqPer], sv[kZqPer], av[kZqCols], bv[kZqCols];
      load_vec(cxy + y * kTile + ag * kZqPer, cv);
      load_vec(sxy + y * kTile + ag * kZqPer, sv);
      load_vec(ar + y * kzp, av);
      load_vec(br + y * kzp, bv);
#pragma unroll
      for (int i = 0; i < kZqPer; ++i)
#pragma unroll
        for (int k = 0; k < kZqCols; ++k)
          part[i][k] = fmaf(sv[i], bv[k], fmaf(cv[i], av[k], part[i][k]));
    }
#pragma unroll
    for (int i = 0; i < kZqPer; ++i)
#pragma unroll
      for (int k = 0; k < kZqCols; ++k) acc[i][k] += part[i][k];
  }
#pragma unroll
  for (int i = 0; i < kZqPer; ++i) {
    const int j = ag * kZqPer + i;
    if (j < cnt) {
      float* row = dzq + (size_t)(n0 + j) * kz2;
#pragma unroll
      for (int k = 0; k < kZqCols; ++k)
        if (col + k < kz2) row[col + k] = acc[i][k];
    }
  }
}

bool bad_shape(int kx, int ky, int kz2, int n, int reps) {
  return kx < 1 || ky < 1 || kz2 < 1 || n < 1 || ky > kMaxKy ||
         kz2 > kMaxKz2 || reps < 1 || reps > 65535 ||
         (long long)kx * reps > 0x7fffffffLL;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Floats per cp.async copy, at most ``widest``, of rows of ``len`` floats
// that start at multiples of ``len`` from pointers whose bits are or-ed in
// ``ptr_bits``.
int copy_width(uintptr_t ptr_bits, int len, int widest) {
  for (int w = widest; w > 1; w /= 2)
    if (len % w == 0 && (ptr_bits & (sizeof(float) * w - 1)) == 0) return w;
  return 1;
}

uintptr_t bits(const float* p) { return reinterpret_cast<uintptr_t>(p); }

// The bits of a replica stride of ``s`` floats, or-ed into a pointer's
// bits: every replica's pointer then meets the alignment the copy width
// asks of the first.
uintptr_t bits(long long s) {
  return static_cast<uintptr_t>(s) * sizeof(float);
}

// abar/bbar rows copy as 8-byte pairs (see load_slab)
bool pairs_ok(const float* abar, const float* bbar, int kz2, long long s_ab) {
  return copy_width(bits(abar) | bits(bbar) | bits(s_ab), kz2, 2) == 2;
}

}  // namespace

extern "C" {

// Ky and 2Kz bounds of the three kernels; then everything the forward's
// launch plan is made from: its atom chunk, most threads per block, most
// splits, most ky rows per block, the micro-tile's rows and columns and the
// most threads that share one.
int cf_sf_limits(int* max_ky, int* max_kz2, int* fwd_chunk, int* fwd_threads,
                 int* fwd_splits, int* fwd_rows, int* fwd_tile_rows,
                 int* fwd_tile_cols, int* fwd_j_split) {
  *max_ky = kMaxKy;
  *max_kz2 = kMaxKz2;
  *fwd_chunk = kFwdChunk;
  *fwd_threads = kFwdThreads;
  *fwd_splits = kFwdMaxSplits;
  *fwd_rows = kFwdMaxRows;
  *fwd_tile_rows = kFwdRows;
  *fwd_tile_cols = kFwdCols;
  *fwd_j_split = kFwdMaxJSplit;
  return 0;
}

// Forward: a and b [kx*ky, kz2] are the outputs.  The launch plan (see
// sf_fwd_kernel): blocks own y_rows ky rows (even), each of their
// micro-tiles j_split threads (at most kFwdMaxJSplit, all within
// kFwdThreads; y_rows within kFwdMaxRows, which keeps the shared memory
// under the card's 227 KB), and
// one of n_splits atom ranges of split_len atoms (a multiple of 4; the last
// range may be short, none is empty; 1, 2, 4 or 8 of them, one cluster).
// ``reps`` replicas R, each at the replica strides (floats) s_x of
// cxT/sxT, s_y of cyT/syT, s_z of zq and s_ab of a/b, run in the same
// launch (R = 1: the single-system launch; its strides are unused).
int cf_sf_fwd(const float* cxT, const float* sxT, const float* cyT,
              const float* syT, const float* zq, float* a, float* b, int kx,
              int ky, int kz2, int n, int y_rows, int j_split, int n_splits,
              int split_len, int reps, long long s_x, long long s_y,
              long long s_z, long long s_ab, void* stream) {
  if (bad_shape(kx, ky, kz2, n, reps)) return (int)cudaErrorInvalidValue;
  if (y_rows < kFwdRows || y_rows % kFwdRows != 0 || y_rows > kFwdMaxRows ||
      j_split < 1 || j_split > kFwdMaxJSplit)
    return (int)cudaErrorInvalidValue;
  const FwdSmem sm{y_rows, ceil4(kz2), j_split};
  const int y_groups = (ky + y_rows - 1) / y_rows;
  if ((long long)sm.owners() * j_split > kFwdThreads || y_groups > 65535 ||
      n_splits < 1 || n_splits > kFwdMaxSplits ||
      (n_splits & (n_splits - 1)) != 0 || split_len < 4 ||
      split_len % 4 != 0 || (long long)(n_splits - 1) * split_len >= n ||
      (long long)n_splits * split_len < n)
    return (int)cudaErrorInvalidValue;
  const int threads = (sm.owners() * j_split + 31) / 32 * 32;
  const size_t smem = sizeof(float) * sm.floats();
  cudaError_t e = allow_smem(sf_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int wt = copy_width(bits(cxT) | bits(sxT) | bits(cyT) | bits(syT) |
                                bits(s_x) | bits(s_y),
                            n, 4);
  const int wz = copy_width(bits(zq) | bits(s_z), kz2, 2);
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = n_splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kx * reps, y_groups, n_splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, sf_fwd_kernel, cxT, sxT, cyT, syT, zq,
                                 a, b, kx, ky, kz2, n, y_rows, j_split,
                                 split_len, wt, wz, s_x, s_y, s_z, s_ab);
}

// Backward, phase tables: dcx/dsx [kx, n] and dcy/dsy [ky, n] are outputs
// (replicas and strides as in cf_sf_fwd; the outputs share the strides of
// the tables they are the cotangents of).
int cf_sf_bwd_tables(const float* cxT, const float* sxT, const float* cyT,
                     const float* syT, const float* zq, const float* abar,
                     const float* bbar, float* dcx, float* dsx, float* dcy,
                     float* dsy, int kx, int ky, int kz2, int n, int reps,
                     long long s_x, long long s_y, long long s_z,
                     long long s_ab, void* stream) {
  if (bad_shape(kx, ky, kz2, n, reps)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kzp = ceil4(kz2), kyp = (ky + kRows - 1) / kRows * kRows;
  const size_t smem = sizeof(float) * ((size_t)2 * Slab{kyp, kzp}.floats() +
                                       (size_t)kzp * kTile +
                                       (size_t)2 * (kyp / kRows) * kTile);
  cudaError_t e = allow_smem(sf_bwd_tables_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sf_bwd_tables_kernel<<<dim3((n + kTile - 1) / kTile, reps),
                         kTile * (kyp / kRows), smem, s>>>(
      cxT, sxT, cyT, syT, zq, abar, bbar, dcx, dsx, dcy, dsy, kx, ky, kz2, n,
      pairs_ok(abar, bbar, kz2, s_ab), s_x, s_y, s_z, s_ab);
  return (int)cudaGetLastError();
}

// Backward, zq: dzq [n, kz2] is the output (replicas and strides as in
// cf_sf_fwd; dzq at the stride s_z of zq).
int cf_sf_bwd_zq(const float* cxT, const float* sxT, const float* cyT,
                 const float* syT, const float* abar, const float* bbar,
                 float* dzq, int kx, int ky, int kz2, int n, int reps,
                 long long s_x, long long s_y, long long s_z, long long s_ab,
                 void* stream) {
  if (bad_shape(kx, ky, kz2, n, reps)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kzp = ceil4(kz2);
  const size_t smem = sizeof(float) * ((size_t)2 * Slab{ky, kzp}.floats() +
                                       (size_t)4 * ky * kTile);
  cudaError_t e = allow_smem(sf_bwd_zq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sf_bwd_zq_kernel<<<dim3((n + kTile - 1) / kTile, reps),
                     kTile / kZqPer * (kzp / kZqCols), smem, s>>>(
      cxT, sxT, cyT, syT, abar, bbar, dzq, kx, ky, kz2, n,
      pairs_ok(abar, bbar, kz2, s_ab), s_x, s_y, s_z, s_ab);
  return (int)cudaGetLastError();
}

}  // extern "C"
