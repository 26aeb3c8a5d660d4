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
// The backward is one thread per (column, row): it reads the <= Wx*Wyp*order
// mesh cotangents its taps touch and forms all three weight cotangents
// locally, so no reduction crosses threads.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxWy = 32;     // Wyp bound (the backward's register arrays,
                               // the forward's Wyp <= 8 * kMaxTM)
constexpr int kMaxOrder = 16;  // spline-order bound of the same

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

__global__ void spread_bwd_kernel(const float* __restrict__ qwlxt,
                                  const float* __restrict__ wlyt,
                                  const float* __restrict__ wzt,
                                  const int* __restrict__ zorg,
                                  const int* __restrict__ offsets,
                                  const float* __restrict__ ct,
                                  float* __restrict__ d_qwlxt,
                                  float* __restrict__ d_wlyt,
                                  float* __restrict__ d_wzt, int n_col,
                                  int wx, int wyp, int order, int rows,
                                  int py, int gz) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (r >= rows) return;
  const size_t qx_base = (size_t)c * wx * rows + r;
  const size_t wy_base = (size_t)c * wyp * rows + r;
  const size_t wz_base = (size_t)c * order * rows + r;
  const int z0 = zorg[(size_t)c * rows + r];
  const int ox = offsets[c];
  const int oy = offsets[n_col + c];

  float wy[kMaxWy], dwy[kMaxWy];
#pragma unroll
  for (int y = 0; y < kMaxWy; ++y) {
    wy[y] = y < wyp ? wlyt[wy_base + (size_t)y * rows] : 0.0f;
    dwy[y] = 0.0f;
  }
  float wz[kMaxOrder], dwz[kMaxOrder];
  int zk[kMaxOrder];
#pragma unroll
  for (int k = 0; k < kMaxOrder; ++k) {
    wz[k] = k < order ? wzt[wz_base + (size_t)k * rows] : 0.0f;
    dwz[k] = 0.0f;
    int g = z0 + k;
    if (g >= gz) g -= gz;
    zk[k] = k < order ? g : 0;
  }

  for (int x = 0; x < wx; ++x) {
    const float qx = qwlxt[qx_base + (size_t)x * rows];
    const float* ctx = ct + ((size_t)(ox + x) * py + oy) * gz;
    float dqx = 0.0f;
#pragma unroll
    for (int y = 0; y < kMaxWy; ++y) {
      if (y < wyp) {
        const float* cty = ctx + (size_t)y * gz;
        const float a = qx * wy[y];
        float da = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxOrder; ++k) {
          if (k < order) {
            const float v = cty[zk[k]];
            da += v * wz[k];
            dwz[k] += a * v;
          }
        }
        dqx += da * wy[y];
        dwy[y] += da * qx;
      }
    }
    d_qwlxt[qx_base + (size_t)x * rows] = dqx;
  }
#pragma unroll
  for (int y = 0; y < kMaxWy; ++y)
    if (y < wyp) d_wlyt[wy_base + (size_t)y * rows] = dwy[y];
#pragma unroll
  for (int k = 0; k < kMaxOrder; ++k)
    if (k < order) d_wzt[wz_base + (size_t)k * rows] = dwz[k];
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

int cf_spread_limits(int* max_wy, int* max_order) {
  *max_wy = kMaxWy;
  *max_order = kMaxOrder;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  spread_bwd_kernel<<<dim3((rows + threads - 1) / threads, n_col), threads,
                      0, s>>>(qwlxt, wlyt, wzt, zorg, offsets, ct, d_qwlxt,
                              d_wlyt, d_wzt, n_col, wx, wyp, order, rows, py,
                              gz);
  return (int)cudaGetLastError();
}

}  // extern "C"
