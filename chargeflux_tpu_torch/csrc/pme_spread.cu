// Cell-column SPME charge spread, forward and backward, for sm_90a.
//
// Replaces chargeflux_tpu/ops/pallas_pme.py: the forward replaces
// _spread_fwd / _fwd_kernel, the backward _spread_bwd / _bwd_kernel.  Same
// contract as spread_columns there: per cell column c (n_col of them), the
// column's atom rows carry transposed compact B-spline weights
//   qwlxt [n_col, Wx, rows]   (x weights times the charge)
//   wlyt  [n_col, Wyp, rows]  (y weights, rows Wy..Wyp-1 zero)
//   wzt   [n_col, order, rows] z taps, placed at (zorg + k) mod Gz
//   zorg  [n_col, rows]        int32 tap-0 mesh index in [0, Gz)
// and the column's patch lands at (ox[c], oy[c]) of an x/y-padded mesh
//   Qpad[ox + x, oy + y, gz] += sum_row qwlxt[x,row] wlyt[y,row] Wz[row,gz].
// The JAX engine is bitwise reproducible, so no kernel here uses float
// atomics: every output element has one writer and a fixed summation order,
// and two launches on the same inputs give the same bits.
//
// What bounds the forward on the H100 (utils/measure.py kernel_bound).  Of
// a row only `order` x, `order` y and `order` z weights are nonzero, and
// only the rows that hold an atom carry charge: at the 30k main path (64
// columns, Wx = Wy 20, Wyp 24, rows 704 of which 31,944 hold an atom, order
// 8, Gz 64) that is 31,944 * 8 * 8 (x, y) pairs of 2*8+1 flops, 35 MFLOP,
// 0.5 us at 67 TFLOP/s f32.  It moves 11.1 MB (3.3 us at 3.35 TB/s), so
// bytes set the bound, 3.3 us.
//
// Forward: a register-tiled product over the contributing rows and a z
// window.
//   spread_patch_kernel: one block per (column, chunk of kXC = 4 x rows), 4
//     warps; 5 chunks x 64 columns = 320 blocks at 30k, 2-3 per SM.  An
//     atom's 8 x weights lie in the middle of its column's 20, so the
//     middle chunks list most of the real rows and the edge chunks few;
//     the chunks launch from the middle out, so that each SM takes one
//     heavy block and light ones.  The block keeps its [kXC*Wyp, Gz] patch
//     in shared memory (row stride Gz|1).  The rows are taken in segments
//     of kSeg = 64 (they are z-cell-major, 88 per z cell at 30k, so a
//     segment spans one or two z cells).  A segment's q w_x, w_y, w_z and
//     zorg rows land in one of two shared stages by cp.async (16-byte
//     copies where rows % 4 == 0, single words otherwise; each stage row's
//     source from a table made once per block), so segment s+1 copies
//     while segment s is used; one block barrier per segment.
//     Contributing rows: those whose q w_x in this chunk is not all zero.
//     Sentinel slots (q = 0) never are, and of an atom's 8 x weights only
//     the chunk's share, so some 25 of a segment's 64 rows contribute at
//     30k on average (71 % of the rows hold an atom, and an atom's weights
//     reach 2-3 of the 5 chunks).  Every warp finds them itself (ballots
//     over the stage, the same answer in each warp, no barrier) and lists
//     them in row order; the product runs over that list only.
//     The z window of a segment: each contributing row's offset from the
//     first contributing row ("ref") is d = ((zorg - ref + Gz/2) mod Gz) -
//     Gz/2; the window is [ref + d_min, ref + d_max + order), W = d_max -
//     d_min + order columns: 15-17 for a segment in one z cell at 30k,
//     23-25 across two.  Any zorg in [0, Gz) is exact: a wide spread only
//     widens W (up to Gz + order - 1), in tiles of up to kTile = 32 columns
//     (at most Gz, so one tile's columns are distinct mesh points; a block
//     barrier between tiles).
//     The product out[(x, y), j] = sum_r (q w_x)[x, r] w_y[y, r]
//     Wz_win[r, j]: lane l of warp w owns the patch rows x = l / 8, y = l %
//     8 + 8 u (u < TM: 3 at Wyp 24) and the 8 window columns 8w..8w+7 of
//     the tile, which it lays itself, dense from the taps, into Wz_win
//     [kSeg][kWinStride] (so no warp waits for another's window).  Per
//     listed row: the left operand on the fly from the stage (one q w_x
//     and TM w_y loads, broadcast or conflict-free with the stage row
//     stride kSeg + 4), 2 broadcast 16-byte Wz_win loads and 24 FMAs into
//     a 3 x 8 register micro-tile.  A warp whose 8 columns lie past W skips
//     the tile (at 30k 2-4 of the 4 warps work).  Each thread then adds
//     its tile into the patch at z = (lo + j) mod Gz, all loads before all
//     stores: one owner per patch element per tile, tiles and segments in
//     order, so the sums have a fixed order.  f32 FMA on the CUDA cores
//     only (no tensor cores, no TF32).  No integer division per row.
//   spread_fold_kernel: one block per (x, y) point column of Qpad.  Its
//     threads test each column's patch offset once, compact the covering
//     columns in column order (ballot + prefix; at most 3 x 3 at 30k) into
//     shared memory, and each thread sums its Gz points over that list, in
//     column order, from the [n_col, Wx, Wyp, Gz] scratch.
//
// Predictions, each written before its first run on the card (PERF.md has
// the readings, from chip_smoke.py phase 3): for a window over all of a
// segment's rows, ~0.5 G FMA (the window ~3x the useful 144 M, the Wyp pad
// 1.2x), the patch pass 0.025-0.05 ms, the fold 0.005-0.015 ms, the
// forward 0.03-0.06 ms, below its plain version (0.30) and below one
// torch.bmm of the dense patch product; for the listed rows, the product
// and A falling ~2.4x with the rows (25 of 64) and one barrier of three
// gone, the patch pass 0.035-0.055 ms and the forward 0.04-0.06 ms, below
// the bmm's 0.070; for the left operand on the fly, double-buffered
// stages and one barrier, the forward 0.045-0.065 ms.
//
// Backward, for the mesh cotangent ct [Px, Py, Gz] and dP its column patch
// (dP[x, y, g] = ct[ox + x, oy + y, g]), per row with taps g_k = (zorg +
// k) mod Gz and h[x, y] = sum_k dP[x, y, g_k] w_z[k]:
//   d_qwlxt[x] = sum_y w_y[y] h[x, y]      (at every x, q w_x zero or not)
//   d_wlyt[y]  = sum_x (q w_x)[x] h[x, y]  (at every y, the pad rows too)
//   d_wzt[k]   = sum_{x,y} (q w_x)[x] w_y[y] dP[x, y, g_k]
// It must write every element.  What bounds it: the work these inputs
// need, 186 MFLOP at 30k (atom rows, nonzero weights), is 2.8 us at 67
// TFLOP/s; it moves 20.5 MB, 6.1 us at 3.35 TB/s: bytes.
//   spread_bwd_kernel: one block of kBwdWarps = 8 warps per (column,
//     segment of kSeg = 64 rows): 64 x 11 = 704 blocks at 30k, 2 per SM
//     (107 KB of shared memory).  The segment's q w_x, w_y, w_z and zorg
//     rows land in a stage by cp.async (16-byte copies where rows % 4 ==
//     0).  Active rows: q w_x or w_y not all zero; every other row's
//     outputs are zero and it costs nothing (the sentinel slots, q = 0,
//     at the origin, of every column whose y patch misses y = 0).
//     Every warp finds the active rows and their z window as the
//     forward does (offsets from
//     the first active row mod Gz, W = 15-17 columns for a segment in one
//     z cell at 30k, 23-25 across two) and the block stages dP[x, y,
//     window] of the column's cotangent (from L2: ct is 1.56 MB) by
//     cp.async into a tile [Wx][Wyp][W | 1] (odd row stride, so the 32
//     lanes' y rows hit 32 banks).  The tile holds every x, so the
//     backward takes Wx <= kMaxWx = 36 (the forward has no Wx limit;
//     tiling x would lift it).  A window wider than kBwdTile = 32
//     goes in tiles, each taking the rows whose 8 taps all lie in it,
//     whole; the next starts at the first row left, so any zorg in [0,
//     Gz) is exact and no row's sums are split.
//     One warp per row, y on the lanes (Wyp <= 32): per x, a lane forms
//     h from its 8 taps (8 conflict-free loads, 8 FMA), d_wlyt[y] +=
//     (q w_x)[x] h in a register, and d_wzt[k] += (q w_x)[x] w_y[y] dP in
//     8 registers; the x loop and its skips are warp-uniform: at an x
//     whose q w_x is zero only w_y h is formed (for d_qwlxt), and nothing
//     if the row's w_y is all zero.  d_qwlxt and d_wzt are sums over the
//     lanes: each lane writes its Wx + order terms into a per-warp
//     scratch [Wx + order][33], and lane i sums row i over the 32 lanes
//     in a fixed order (four chains, lanes j mod 4; h too is two chains,
//     even and odd taps, and the x loop is unrolled 4: the latency of one
//     dependent chain per row was what 16 warps per SM could not hide).
//     The row's results go into the stage in place of its inputs (no
//     other warp reads them), and the block writes the stage out as it
//     came in, coalesced.  No float atomics, no TF32: every
//     element has one writer and a fixed order, so two launches give the
//     same bits.
// Prediction, written before its first run on the card: ~600 warp
// instructions per active row (31,944 atom rows and the sentinel rows of
// the columns whose y patch covers the origin at 30k), 20 M in all, ~22
// us at full issue; the 8-tap loads take ~250 shared-memory wavefronts a
// row, ~35 us at one a clock per SM, so shared memory bounds it; with the two copy latencies
// per block and 2.7 waves of blocks, 0.045-0.09 ms, below the plain
// version's two torch.bmm (0.188 ms) and the plain version (0.55 ms).
// (The backward it replaces, one thread per (column, row) looping over
// all Wx * Wyp * order taps from global memory, took 0.525 ms.)

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxWy = 32;     // Wyp bound (the forward's Wyp <= 8 * kMaxTM,
                               // the backward's lane = y)
constexpr int kMaxOrder = 16;  // spline-order bound of the same
constexpr int kMaxWx = 36;     // Wx bound (the backward's shared memory)

constexpr int kSeg = 64;             // rows per staged segment
constexpr int kSegP = kSeg + 4;      // a stage row's stride: 16-byte rows,
                                     // 8 consecutive rows on 8 bank quads
constexpr int kRJ = kSeg / 32;       // rows of a segment per lane
constexpr int kXC = 4;               // x rows of a column per block
constexpr int kWarps = 4;            // warps per forward block
constexpr int kTN = 8;               // window columns per warp (registers)
constexpr int kTile = kWarps * kTN;  // window columns per tile
constexpr int kWinStride = kTile + 4;  // its shared row stride (16-byte
                                       // rows; taps of rows r..r+31 at one
                                       // column hit 8 banks, not 1)
constexpr int kMaxTM = (kMaxWy + 7) / 8;  // patch rows per lane
constexpr int kBwdWarps = 8;         // warps per backward block
constexpr int kBwdTile = 32;         // window columns per backward tile
                                     // (one per lane in its copy)
constexpr int kScr = 33;             // a backward scratch row's stride
static_assert(kSeg % 32 == 0, "segments are whole warps of rows");
static_assert(kXC * 8 == 32, "a lane owns one x row and every 8th y row");

__host__ __device__ constexpr int ceil4(int v) { return (v + 3) & ~3; }

// Shared memory of one forward block, in floats: the patch [kXC*Wyp][ps],
// two stages (q w_x [kXC], w_y [Wyp], w_z [order] and zorg rows of kSegP),
// the window Wz_win [kSeg][kWinStride] over the segment's contributing
// rows, and each warp's list of those rows (kWarps x kSeg ints).
struct FwdSmem {
  int wyp, order, gz;
  __host__ __device__ int ps() const { return gz | 1; }
  __host__ __device__ int patch() const { return ceil4(kXC * wyp * ps()); }
  __host__ __device__ int stage() const {
    return (kXC + wyp + order + 1) * kSegP;
  }
  __host__ __device__ int win() const { return kSeg * kWinStride; }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) *
           (size_t)(patch() + 2 * stage() + win() + kWarps * kSeg);
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v mod gz for v in [-gz, 2 gz) (zorg is in [0, gz) by the contract above)
__device__ __forceinline__ int wrap_gz(int v, int gz) {
  v = v >= gz ? v - gz : v;
  return v < 0 ? v + gz : v;
}

// Start the copy of the segment at row r0 into the stage st, as one
// cp.async group: stage row q (< n_rows) from the global row src[q] into
// st + dst[q].  Rows past the last (r0 + kSeg > rows) are zero, so they
// contribute nothing.  vec: rows % 4 == 0 and the inputs 16-byte aligned,
// so every row copies as 16-byte quads.
__device__ __forceinline__ void load_segment(float* st,
                                             const float* const* src,
                                             const int* dst, int n_rows,
                                             int rows, int r0, bool vec) {
  const int cnt = min(kSeg, rows - r0);
  const int shift = vec ? 4 : 6;  // log2 of the copies per row
  for (int i = threadIdx.x; i < n_rows << shift; i += blockDim.x) {
    const int q = i >> shift;
    const int col = vec ? (i & 15) << 2 : i & 63;
    float* d = st + dst[q] + col;
    if (col >= cnt) {
      d[0] = 0.0f;
      if (vec) d[1] = d[2] = d[3] = 0.0f;
    } else if (vec) {
      cp_async16(d, src[q] + r0 + col);
    } else {
      cp_async4(d, src[q] + r0 + col);
    }
  }
  cp_async_commit();
}

template <int TM>
__global__ void __launch_bounds__(kWarps * 32)
    spread_patch_kernel(const float* __restrict__ qwlxt,
                        const float* __restrict__ wlyt,
                        const float* __restrict__ wzt,
                        const int* __restrict__ zorg,
                        float* __restrict__ scratch, int wx, int wyp,
                        int order, int rows, int gz, bool vec) {
  extern __shared__ __align__(16) float fwd_smem[];
  const FwdSmem sm{wyp, order, gz};
  const int ps = sm.ps();
  float* patch = fwd_smem;
  float* stages = patch + sm.patch();
  float* win = stages + 2 * sm.stage();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* rows_w = reinterpret_cast<int*>(win + sm.win()) + warp * kSeg;

  // x chunks from the middle out (chunk order mid, mid-1, mid+1, ...): an
  // atom's x weights sit in the middle of its column's patch, so the
  // middle chunks list the most rows; launched first, each shares its SM
  // with the light edge chunks
  const int c = blockIdx.x;
  const int off = (blockIdx.y + 1) / 2;
  const int x0 = (gridDim.y / 2 + (blockIdx.y & 1 ? -off : off)) * kXC;
  const int xc = min(kXC, wx - x0);
  // lane's patch rows: x row lx, y rows ly + 8 u (u < TM); rows past the
  // block's (lx >= xc, y >= wyp) read a real stage row and are not stored
  const int lx = lane >> 3, ly = lane & 7;
  const int qx_off = min(lx, xc - 1) * kSegP;
  int wy_off[TM];
  bool live[TM];
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    live[u] = lx < xc && ly + 8 * u < wyp;
    wy_off[u] = (kXC + min(ly + 8 * u, wyp - 1)) * kSegP;
  }
  // window columns per tile: at most Gz, so a tile's columns are distinct
  // mesh points across warps (a warp adds its own 8 columns in turn)
  const int te = min(kTile, max(kTN, gz / kTN * kTN));
  const int j0 = warp * kTN;             // this warp's window columns
  // the global row and the stage offset of each stage row: xc rows of
  // q w_x, Wyp of w_y, order of w_z and the zorg row
  __shared__ const float* src_tab[kXC + kMaxWy + kMaxOrder + 1];
  __shared__ int dst_tab[kXC + kMaxWy + kMaxOrder + 1];
  const int n_rows = xc + wyp + order + 1;
  for (int q = threadIdx.x; q < n_rows; q += blockDim.x) {
    const float* g;
    if (q < xc)
      g = qwlxt + ((size_t)c * wx + x0 + q) * rows;
    else if (q < xc + wyp)
      g = wlyt + ((size_t)c * wyp + q - xc) * rows;
    else if (q < xc + wyp + order)
      g = wzt + ((size_t)c * order + q - xc - wyp) * rows;
    else
      g = reinterpret_cast<const float*>(zorg) + (size_t)c * rows;
    src_tab[q] = g;
    dst_tab[q] = (q < xc ? q : kXC + q - xc) * kSegP;
  }
  for (int i = threadIdx.x; i < kXC * wyp * ps; i += blockDim.x)
    patch[i] = 0.0f;
  __syncthreads();
  const int n_seg = (rows + kSeg - 1) / kSeg;
  load_segment(stages, src_tab, dst_tab, n_rows, rows, 0, vec);

  for (int s = 0; s < n_seg; ++s) {
    // segment s is staged; every warp is done with segment s - 1, whose
    // stage takes segment s + 1 now, and with the patch adds before
    cp_async_wait_all();
    __syncthreads();
    const float* st = stages + (s & 1) * sm.stage();
    if (s + 1 < n_seg)
      load_segment(stages + ((s + 1) & 1) * sm.stage(), src_tab, dst_tab,
                   n_rows, rows, (s + 1) * kSeg, vec);
    const float* st_wz = st + (kXC + wyp) * kSegP;
    const int* st_zo = reinterpret_cast<const int*>(st_wz + order * kSegP);
    // Every warp finds the same contributing rows (q w_x in this chunk not
    // all zero) and lists them in row order: lane l holds rows l + 32 j,
    // at list positions pos[j] < n.
    bool hit[kRJ];
    int pos[kRJ], d[kRJ];
    int n = 0, first = -1;
#pragma unroll
    for (int j = 0; j < kRJ; ++j) {
      const int r = 32 * j + lane;
      bool h = false;
      for (int x = 0; x < xc; ++x) h |= st[x * kSegP + r] != 0.0f;
      const unsigned ball = __ballot_sync(~0u, h);
      hit[j] = h;
      pos[j] = n + __popc(ball & ((1u << lane) - 1u));
      n += __popc(ball);
      if (first < 0 && ball) first = 32 * j + __ffs(ball) - 1;
      if (h) rows_w[pos[j]] = r;
    }
    if (n == 0) continue;  // no row of the segment contributes
    // the segment's z window, over the contributing rows
    const int ref = st_zo[first];
    int dmin = INT_MAX, dmax = INT_MIN;
#pragma unroll
    for (int j = 0; j < kRJ; ++j) {
      d[j] = 0;
      if (hit[j]) {
        d[j] = wrap_gz(st_zo[32 * j + lane] - ref + gz / 2, gz) - gz / 2;
        dmin = min(dmin, d[j]);
        dmax = max(dmax, d[j]);
      }
    }
    dmin = __reduce_min_sync(~0u, dmin);
    dmax = __reduce_max_sync(~0u, dmax);
    const int w = dmax - dmin + order;
    const int lo = wrap_gz(ref + dmin, gz);
    const int n_tiles = (w + te - 1) / te;
    for (int t = 0; t < n_tiles; ++t) {
      // the patch adds of the tile before are done (a z recurs when W > te)
      if (t > 0) __syncthreads();
      const bool mine = j0 < te && t * te + j0 < w;
      if (!mine) continue;
      // a warp lays and reads only its own 8 window columns
#pragma unroll
      for (int j = 0; j < kRJ; ++j) {
        if (!hit[j]) continue;
        const int r = 32 * j + lane;
        const int k0 = j0 + t * te - (d[j] - dmin);
        float v[kTN];
#pragma unroll
        for (int k = 0; k < kTN; ++k)
          v[k] = k0 + k >= 0 && k0 + k < order
                     ? st_wz[(k0 + k) * kSegP + r]
                     : 0.0f;
        float4* dst =
            reinterpret_cast<float4*>(win + pos[j] * kWinStride + j0);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncwarp();
      // out[(x, y), j] += (q w_x)[x, r] w_y[y, r] Wz_win[r, j] over the
      // listed rows r, the left operand formed on the fly
      float acc[TM][kTN];
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int k = 0; k < kTN; ++k) acc[u][k] = 0.0f;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const int r = rows_w[i];
        const float q = st[qx_off + r];
        float av[TM];
#pragma unroll
        for (int u = 0; u < TM; ++u) av[u] = q * st[wy_off[u] + r];
        const float4 b0 =
            *reinterpret_cast<const float4*>(win + i * kWinStride + j0);
        const float4 b1 =
            *reinterpret_cast<const float4*>(win + i * kWinStride + j0 + 4);
        const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int u = 0; u < TM; ++u)
#pragma unroll
          for (int k = 0; k < kTN; ++k)
            acc[u][k] = fmaf(av[u], bv[k], acc[u][k]);
      }
      // into the patch at z = (lo + j) mod Gz: all loads, then all stores
      // (the elements are distinct, so they need not wait on each other)
      int zk[kTN];
      float old[TM][kTN];
      const int kn = min(kTN, w - t * te - j0);
      zk[0] = (lo + t * te + j0) % gz;
#pragma unroll
      for (int k = 1; k < kTN; ++k)
        zk[k] = zk[k - 1] + 1 < gz ? zk[k - 1] + 1 : 0;
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int k = 0; k < kTN; ++k)
          if (live[u] && k < kn)
            old[u][k] = patch[(lx * wyp + ly + 8 * u) * ps + zk[k]];
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int k = 0; k < kTN; ++k)
          if (live[u] && k < kn)
            patch[(lx * wyp + ly + 8 * u) * ps + zk[k]] =
                old[u][k] + acc[u][k];
      __syncwarp();  // the window is read before the next tile lays it
    }
  }
  __syncthreads();
  float* out = scratch + ((size_t)c * wx + x0) * wyp * gz;
  for (int m = warp; m < xc * wyp; m += kWarps)
    for (int z = lane; z < gz; z += 32) out[m * gz + z] = patch[m * ps + z];
}

// One block per (x, y) point column of Qpad: the covering patches in column
// order, then each thread sums its points over them.
__global__ void spread_fold_kernel(const float* __restrict__ scratch,
                                   const int* __restrict__ offsets,
                                   float* __restrict__ qpad, int n_col,
                                   int wx, int wyp, int py, int gz) {
  extern __shared__ int cover[];  // [n_col] scratch offsets, column order
  __shared__ int warp_n[32];
  const int xx = blockIdx.x / py, yy = blockIdx.x % py;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int n = 0;
  for (int base = 0; base < n_col; base += blockDim.x) {
    const int c = base + threadIdx.x;
    int lx = 0, ly = 0;
    bool hit = false;
    if (c < n_col) {
      lx = xx - offsets[c];
      ly = yy - offsets[n_col + c];
      hit = lx >= 0 && lx < wx && ly >= 0 && ly < wyp;
    }
    const unsigned ball = __ballot_sync(~0u, hit);
    if (lane == 0) warp_n[warp] = __popc(ball);
    __syncthreads();
    int at = n;
    for (int v = 0; v < warp; ++v) at += warp_n[v];
    if (hit)
      cover[at + __popc(ball & ((1u << lane) - 1u))] =
          ((c * wx + lx) * wyp + ly) * gz;
    for (int v = 0; v < n_warps; ++v) n += warp_n[v];
    __syncthreads();
  }
  for (int g = threadIdx.x; g < gz; g += blockDim.x) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) acc += scratch[cover[i] + g];
    qpad[(size_t)blockIdx.x * gz + g] = acc;
  }
}

// Shared memory of one backward block, in floats: the stage (q w_x [Wx],
// w_y [Wyp], w_z [order] and zorg rows of kSegP; each row's outputs land
// in place), the cotangent tile [Wx][Wyp][kBwdTile | 1], and each warp's
// reduction scratch [Wx + order][kScr].
struct BwdSmem {
  int wx, wyp, order;
  __host__ __device__ constexpr int stage() const {
    return (wx + wyp + order + 1) * kSegP;
  }
  __host__ __device__ constexpr int tile() const {
    return ceil4(wx * wyp * (kBwdTile + 1));
  }
  __host__ __device__ constexpr int scratch() const {
    return kBwdWarps * (wx + order) * kScr;
  }
  __host__ __device__ constexpr size_t bytes() const {
    return sizeof(float) * (size_t)(stage() + tile() + scratch());
  }
};
static_assert(BwdSmem{kMaxWx, kMaxWy, kMaxOrder}.bytes() <= 232448,
              "the largest backward block fits the H100's shared memory");

// Global row q of the backward's stage: q w_x rows, then w_y, w_z, zorg.
__device__ __forceinline__ float* bwd_row_ptr(float* qx, float* wy, float* wz,
                                              float* zo, int c, int q,
                                              int wx, int wyp, int order,
                                              int rows) {
  if (q < wx) return qx + ((size_t)c * wx + q) * rows;
  q -= wx;
  if (q < wyp) return wy + ((size_t)c * wyp + q) * rows;
  q -= wyp;
  if (q < order) return wz + ((size_t)c * order + q) * rows;
  return zo + (size_t)c * rows;
}

// One row of the backward, by one warp, lane = y, its 8 (order) taps at
// tile columns col..col+order-1.  Results land in the stage in place of
// the row's inputs: d_qwlxt over q w_x, d_wlyt over w_y, d_wzt over w_z.
template <int ORD, bool GUARD>
__device__ __forceinline__ void bwd_row(float* st_qx, float* st_wy,
                                        float* st_wz, const float* tile,
                                        float* scr, int r, int col, int ts,
                                        int wx, int wyp, int order,
                                        int lane) {
  const float wyl = lane < wyp ? st_wy[lane * kSegP + r] : 0.0f;
  const bool any_wy = __any_sync(~0u, wyl != 0.0f);
  float wz[ORD], dwz[ORD];
#pragma unroll
  for (int k = 0; k < ORD; ++k) {
    wz[k] = !GUARD || k < order ? st_wz[k * kSegP + r] : 0.0f;
    dwz[k] = 0.0f;
  }
  float dwy = 0.0f;
  // lanes past Wyp read row Wyp-1 (a broadcast) and have w_y = 0
  const float* trow = tile + min(lane, wyp - 1) * ts + col;
  const int xstride = wyp * ts;
#pragma unroll 4
  for (int x = 0; x < wx; ++x) {
    const float q = st_qx[x * kSegP + r];
    float dq = 0.0f;
    // warp-uniform: at an x whose q w_x is 0 only d_qwlxt needs h, and
    // only if some w_y of the row is not 0
    if (q != 0.0f || any_wy) {
      const float* p = trow + x * xstride;
      float v[ORD];
      float h0 = 0.0f, h1 = 0.0f;  // two chains: even and odd taps
#pragma unroll
      for (int k = 0; k < ORD; ++k) {
        v[k] = !GUARD || k < order ? p[k] : 0.0f;
        if (k & 1)
          h1 = fmaf(v[k], wz[k], h1);
        else
          h0 = fmaf(v[k], wz[k], h0);
      }
      const float h = h0 + h1;
      dq = wyl * h;
      if (q != 0.0f) {
        dwy = fmaf(q, h, dwy);
        const float a = q * wyl;
#pragma unroll
        for (int k = 0; k < ORD; ++k) dwz[k] = fmaf(a, v[k], dwz[k]);
      }
    }
    scr[x * kScr + lane] = dq;
  }
#pragma unroll
  for (int k = 0; k < ORD; ++k)
    if (!GUARD || k < order) scr[(wx + k) * kScr + lane] = dwz[k];
  __syncwarp();
  // d_qwlxt[x] and d_wzt[k]: each a sum over the 32 lanes in a fixed
  // order (four chains over lanes j mod 4, then paired)
  for (int i = lane; i < wx + order; i += 32) {
    const float* row = scr + i * kScr;
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 32; ++j) part[j & 3] += row[j];
    const float sum = (part[0] + part[1]) + (part[2] + part[3]);
    if (i < wx)
      st_qx[i * kSegP + r] = sum;
    else
      st_wz[(i - wx) * kSegP + r] = sum;
  }
  if (lane < wyp) st_wy[lane * kSegP + r] = dwy;
  __syncwarp();  // the scratch is read before the next row writes it
}

template <int ORD, bool GUARD>
__global__ void __launch_bounds__(kBwdWarps * 32, 2)
    spread_bwd_kernel(const float* __restrict__ qwlxt,
                      const float* __restrict__ wlyt,
                      const float* __restrict__ wzt,
                      const int* __restrict__ zorg,
                      const int* __restrict__ offsets,
                      const float* __restrict__ ct,
                      float* __restrict__ d_qwlxt,
                      float* __restrict__ d_wlyt,
                      float* __restrict__ d_wzt, int n_col, int wx, int wyp,
                      int order, int rows, int py, int gz, bool vec) {
  extern __shared__ __align__(16) float bwd_smem[];
  const BwdSmem sm{wx, wyp, order};
  float* st = bwd_smem;
  float* tile = st + sm.stage();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* scr = tile + sm.tile() + warp * (wx + order) * kScr;
  float* st_qx = st;
  float* st_wy = st_qx + wx * kSegP;
  float* st_wz = st_wy + wyp * kSegP;
  const int* st_zo = reinterpret_cast<const int*>(st_wz + order * kSegP);
  const int c = blockIdx.x, r0 = blockIdx.y * kSeg;
  const int cnt = min(kSeg, rows - r0);
  const int n_rows = wx + wyp + order + 1;

  // the segment's rows into the stage (rows past the last are zero); a
  // warp copies two rows a step as 16-byte quads when vec, else one row
  // as words
  {
    float* in[4] = {const_cast<float*>(qwlxt), const_cast<float*>(wlyt),
                    const_cast<float*>(wzt),
                    reinterpret_cast<float*>(const_cast<int*>(zorg))};
    const int per = vec ? 2 : 1;
    for (int q0 = warp * per; q0 < n_rows; q0 += kBwdWarps * per) {
      const int q = q0 + (vec ? lane >> 4 : 0);
      if (q >= n_rows) continue;
      const float* g = bwd_row_ptr(in[0], in[1], in[2], in[3], c, q, wx,
                                   wyp, order, rows) + r0;
      float* d = st + q * kSegP;
      if (vec) {
        const int col = (lane & 15) << 2;
        if (col < cnt)
          cp_async16(d + col, g + col);
        else
          d[col] = d[col + 1] = d[col + 2] = d[col + 3] = 0.0f;
      } else {
        for (int col = lane; col < kSeg; col += 32) {
          if (col < cnt)
            cp_async4(d + col, g + col);
          else
            d[col] = 0.0f;
        }
      }
    }
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();

  // Active rows: q w_x or w_y not all zero (every output of another row
  // is zero).  Every warp finds them itself, lane l holding rows l and
  // l + 32, and the z window over them as the forward does: offsets d
  // from the first active row's zorg mod Gz, window [lo, lo + W) with W
  // = d_max - d_min + order, a row's taps at window column s = d - d_min.
  static_assert(kRJ == 2, "a lane holds two rows of a segment");
  bool act[kRJ];
  int s[kRJ];
  int first = -1;
#pragma unroll
  for (int j = 0; j < kRJ; ++j) {
    const int r = 32 * j + lane;
    bool a = false;
    for (int x = 0; x < wx; ++x) a |= st_qx[x * kSegP + r] != 0.0f;
    for (int y = 0; y < wyp; ++y) a |= st_wy[y * kSegP + r] != 0.0f;
    act[j] = a;
    const unsigned ball = __ballot_sync(~0u, a);
    if (first < 0 && ball) first = 32 * j + __ffs(ball) - 1;
  }
  if (first >= 0) {
    const int ref = st_zo[first];
    int dmin = INT_MAX, dmax = INT_MIN;
#pragma unroll
    for (int j = 0; j < kRJ; ++j) {
      s[j] = wrap_gz(st_zo[32 * j + lane] - ref + gz / 2, gz) - gz / 2;
      if (act[j]) {
        dmin = min(dmin, s[j]);
        dmax = max(dmax, s[j]);
      }
    }
    dmin = __reduce_min_sync(~0u, dmin);
    dmax = __reduce_max_sync(~0u, dmax);
#pragma unroll
    for (int j = 0; j < kRJ; ++j) s[j] -= dmin;
    const int w = dmax - dmin + order;
    const int lo = wrap_gz(ref + dmin, gz);
    const int ox = offsets[c], oy = offsets[n_col + c];
    // Tiles of up to kBwdTile window columns: a tile from column base
    // takes every active row whose taps all lie in it (s <= base +
    // kBwdTile - order), whole; the next tile starts at the first row
    // left.  So each row is done once, in one tile (at 30k every window
    // is one tile), and any zorg in [0, Gz) is exact.
    int base = 0;
    for (;;) {
      const int tw = min(kBwdTile, w - base);
      const int ts = tw | 1;  // odd: lanes (y) on distinct banks
      __syncthreads();        // every warp is done with the tile before
      const int zl = (lo + base + lane) % gz;
      for (int x = 0; x < wx; ++x)
        for (int y = warp; y < wyp; y += kBwdWarps)
          if (lane < tw)
            cp_async4(tile + (x * wyp + y) * ts + lane,
                      ct + ((size_t)(ox + x) * py + oy + y) * gz + zl);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      const int hi = base + kBwdTile - order;
      for (int r = warp; r < cnt; r += kBwdWarps) {
        const int src = r & 31;
        const int sr = __shfl_sync(~0u, r < 32 ? s[0] : s[1], src);
        const bool ar = __shfl_sync(~0u, r < 32 ? act[0] : act[1], src);
        if (!ar || sr < base || sr > hi) continue;
        bwd_row<ORD, GUARD>(st_qx, st_wy, st_wz, tile, scr, r, sr - base,
                            ts, wx, wyp, order, lane);
      }
      int nb = INT_MAX;
#pragma unroll
      for (int j = 0; j < kRJ; ++j)
        if (act[j] && s[j] > hi) nb = min(nb, s[j]);
      nb = __reduce_min_sync(~0u, nb);
      if (nb == INT_MAX) break;
      base = nb;
    }
  }
  // an inactive row's d_wzt is zero (its d_qwlxt and d_wlyt, over its
  // zero q w_x and w_y rows, are already)
  for (int r = warp; r < cnt; r += kBwdWarps) {
    const bool ar = __shfl_sync(~0u, r < 32 ? act[0] : act[1], r & 31);
    if (!ar)
      for (int k = lane; k < order; k += 32) st_wz[k * kSegP + r] = 0.0f;
  }
  __syncthreads();
  // the stage's output rows out, as they came in
  const int n_out = wx + wyp + order;
  for (int q = warp; q < n_out; q += kBwdWarps) {
    float* g = bwd_row_ptr(d_qwlxt, d_wlyt, d_wzt, nullptr, c, q, wx, wyp,
                           order, rows) + r0;
    const float* d = st + q * kSegP;
    if (vec) {
      const int col = lane << 2;
      if (lane < 16 && col < cnt)
        *reinterpret_cast<float4*>(g + col) =
            *reinterpret_cast<const float4*>(d + col);
    } else {
      for (int col = lane; col < cnt; col += 32) g[col] = d[col];
    }
  }
}

template <int ORD, bool GUARD>
cudaError_t launch_bwd(const float* qwlxt, const float* wlyt,
                       const float* wzt, const int* zorg, const int* offsets,
                       const float* ct, float* d_qwlxt, float* d_wlyt,
                       float* d_wzt, int n_col, int wx, int wyp, int order,
                       int rows, int py, int gz, bool vec, cudaStream_t s) {
  const size_t smem = BwdSmem{wx, wyp, order}.bytes();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        spread_bwd_kernel<ORD, GUARD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  spread_bwd_kernel<ORD, GUARD>
      <<<dim3(n_col, (rows + kSeg - 1) / kSeg), kBwdWarps * 32, smem, s>>>(
          qwlxt, wlyt, wzt, zorg, offsets, ct, d_qwlxt, d_wlyt, d_wzt, n_col,
          wx, wyp, order, rows, py, gz, vec);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_patch(const float* qwlxt, const float* wlyt,
                         const float* wzt, const int* zorg, float* scratch,
                         int n_col, int wx, int wyp, int order, int rows,
                         int gz, bool vec, cudaStream_t s) {
  const size_t smem = FwdSmem{wyp, order, gz}.bytes();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        spread_patch_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  spread_patch_kernel<TM><<<dim3(n_col, (wx + kXC - 1) / kXC), kWarps * 32,
                            smem, s>>>(qwlxt, wlyt, wzt, zorg, scratch, wx,
                                       wyp, order, rows, gz, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cf_spread_limits(int* max_wy, int* max_order, int* max_wx) {
  *max_wy = kMaxWy;
  *max_order = kMaxOrder;
  *max_wx = kMaxWx;
  return 0;
}

// Forward: scratch [n_col, wx, wyp, gz] and qpad [px, py, gz] are outputs
// allocated by the caller; offsets is int32 [2, n_col] (ox row, oy row).
int cf_spread_fwd(const float* qwlxt, const float* wlyt, const float* wzt,
                  const int* zorg, const int* offsets, float* scratch,
                  float* qpad, int n_col, int wx, int wyp, int order,
                  int rows, int px, int py, int gz, void* stream) {
  if (n_col < 1 || wx < 1 || wyp < 1 || wyp > kMaxWy || order < 1 ||
      order > kMaxOrder || rows < 1 || gz < kTN ||
      (long long)n_col * wx * wyp * gz > INT_MAX ||
      (size_t)n_col * sizeof(int) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = rows % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(qwlxt) |
                     reinterpret_cast<uintptr_t>(wlyt) |
                     reinterpret_cast<uintptr_t>(wzt) |
                     reinterpret_cast<uintptr_t>(zorg)) & 15) == 0;
  // the register tile: 3 y rows a lane at Wyp <= 24 (the main path's),
  // kMaxTM up to kMaxWy
  const cudaError_t e =
      wyp <= 24
          ? launch_patch<3>(qwlxt, wlyt, wzt, zorg, scratch, n_col, wx, wyp,
                            order, rows, gz, vec, s)
          : launch_patch<kMaxTM>(qwlxt, wlyt, wzt, zorg, scratch, n_col, wx,
                                 wyp, order, rows, gz, vec, s);
  if (e != cudaSuccess) return (int)e;
  const int threads = min(256, (gz + 31) / 32 * 32);
  spread_fold_kernel<<<px * py, threads, n_col * sizeof(int), s>>>(
      scratch, offsets, qpad, n_col, wx, wyp, py, gz);
  return (int)cudaGetLastError();
}

// Backward: d_qwlxt / d_wlyt / d_wzt have the shapes of the inputs.
int cf_spread_bwd(const float* qwlxt, const float* wlyt, const float* wzt,
                  const int* zorg, const int* offsets, const float* ct,
                  float* d_qwlxt, float* d_wlyt, float* d_wzt, int n_col,
                  int wx, int wyp, int order, int rows, int py, int gz,
                  void* stream) {
  if (n_col < 1 || wx < 1 || wx > kMaxWx || wyp < 1 || wyp > kMaxWy ||
      order < 1 || order > kMaxOrder || rows < 1 || gz < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = rows % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(qwlxt) |
                     reinterpret_cast<uintptr_t>(wlyt) |
                     reinterpret_cast<uintptr_t>(wzt) |
                     reinterpret_cast<uintptr_t>(zorg) |
                     reinterpret_cast<uintptr_t>(d_qwlxt) |
                     reinterpret_cast<uintptr_t>(d_wlyt) |
                     reinterpret_cast<uintptr_t>(d_wzt)) & 15) == 0;
  // the tap loops unrolled for order 8 (pme.DEFAULT_ORDER, the main
  // path's), guarded up to kMaxOrder for any other order
  const cudaError_t e =
      order == 8
          ? launch_bwd<8, false>(qwlxt, wlyt, wzt, zorg, offsets, ct, d_qwlxt,
                                 d_wlyt, d_wzt, n_col, wx, wyp, order, rows,
                                 py, gz, vec, s)
          : launch_bwd<kMaxOrder, true>(qwlxt, wlyt, wzt, zorg, offsets, ct,
                                        d_qwlxt, d_wlyt, d_wzt, n_col, wx,
                                        wyp, order, rows, py, gz, vec, s);
  return (int)e;
}

}  // extern "C"
