// Classical-Ewald structure factors, forward and backward, for sm_90a.
//
// Replaces chargeflux_tpu/ops/pallas_recip.py (make_structure_factor_fn):
//   sf_fwd_kernel + sf_sum_kernel  replace _fwd_impl / _fwd_kernel
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
// Forward.  One block per (kx, chunk of kChunk atoms) forms the chunk's
// cxy/sxy rows for that kx in shared memory once, stages the chunk's zq
// rows, and each thread owns (ky, c) outputs of A and B over the chunk; the
// per-chunk partials [2, chunks, Kx*Ky, 2Kz] are then summed in chunk order
// by sf_sum_kernel (one thread per output).
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

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxKy = 64;      // Ky = 2 kmax_y - 1 bound (kmax_y <= 32)
constexpr int kMaxKz2 = 128;    // 2Kz = 2 (2 kmax_z - 1) bound (kmax_z <= 32)
constexpr int kChunk = 64;      // atoms per forward block
constexpr int kFwdThreads = 256;
constexpr int kTile = 16;       // atoms per backward block
constexpr int kRows = 2;        // ky rows of one atom per tables thread
constexpr int kZqPer = 2, kZqCols = 2;  // atoms x dzq columns per zq thread

__host__ __device__ constexpr int ceil4(int v) { return (v + 3) & ~3; }

__global__ void sf_fwd_kernel(const float* __restrict__ cxT,
                              const float* __restrict__ sxT,
                              const float* __restrict__ cyT,
                              const float* __restrict__ syT,
                              const float* __restrict__ zq,
                              float* __restrict__ partial, int kx, int ky,
                              int kz2, int n) {
  extern __shared__ float smem[];
  float* cxy = smem;                 // [ky][kChunk]
  float* sxy = cxy + ky * kChunk;    // [ky][kChunk]
  float* zs = sxy + ky * kChunk;     // [kChunk][kz2]
  const int x = blockIdx.x;
  const int chunk = blockIdx.y;
  const int n0 = chunk * kChunk;
  const int cnt = min(kChunk, n - n0);

  for (int i = threadIdx.x; i < ky * kChunk; i += blockDim.x) {
    const int y = i / kChunk;
    const int j = i % kChunk;
    float c = 0.0f, s = 0.0f;
    if (j < cnt) {
      const size_t a = (size_t)n0 + j;
      const float cx = cxT[(size_t)x * n + a], sx = sxT[(size_t)x * n + a];
      const float cy = cyT[(size_t)y * n + a], sy = syT[(size_t)y * n + a];
      c = cx * cy - sx * sy;
      s = sx * cy + cx * sy;
    }
    cxy[i] = c;
    sxy[i] = s;
  }
  for (int i = threadIdx.x; i < cnt * kz2; i += blockDim.x)
    zs[i] = zq[(size_t)n0 * kz2 + i];
  __syncthreads();

  const size_t kxy = (size_t)kx * ky;
  float* pa = partial + ((size_t)chunk * kxy + (size_t)x * ky) * kz2;
  float* pb = partial + ((size_t)(gridDim.y + chunk) * kxy + (size_t)x * ky)
                            * kz2;
  for (int o = threadIdx.x; o < ky * kz2; o += blockDim.x) {
    const int y = o / kz2;
    const int c = o % kz2;
    const float* cr = cxy + y * kChunk;
    const float* sr = sxy + y * kChunk;
    float a = 0.0f, b = 0.0f;
    for (int j = 0; j < cnt; ++j) {
      const float z = zs[j * kz2 + c];
      a = fmaf(cr[j], z, a);
      b = fmaf(sr[j], z, b);
    }
    pa[o] = a;
    pb[o] = b;
  }
}

// out = sum over chunks, in chunk order, of partial [2, n_chunks, m].
__global__ void sf_sum_kernel(const float* __restrict__ partial,
                              float* __restrict__ a, float* __restrict__ b,
                              int n_chunks, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * m) return;
  const int which = i / m;
  const int idx = i % m;
  const float* p = partial + (size_t)which * n_chunks * m + idx;
  float acc = 0.0f;
  for (int k = 0; k < n_chunks; ++k) acc += p[(size_t)k * m];
  (which ? b : a)[idx] = acc;
}

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

// f(y, c) for the elements threadIdx.x, + blockDim.x, ... of a [rows, cols]
// array in row order, without a division per element.
template <typename F>
__device__ __forceinline__ void strided_2d(int rows, int cols, F f) {
  const int dy = blockDim.x / cols, dc = blockDim.x % cols;
  for (int y = threadIdx.x / cols, c = threadIdx.x % cols; y < rows;) {
    f(y, c);
    y += dy;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++y;
    }
  }
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
    float* __restrict__ dsy, int kx, int ky, int kz2, int n, bool pairs) {
  extern __shared__ __align__(16) float bwd_smem[];
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
    float* __restrict__ dzq, int kx, int ky, int kz2, int n, bool pairs) {
  extern __shared__ __align__(16) float bwd_smem[];
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

bool bad_shape(int kx, int ky, int kz2, int n) {
  return kx < 1 || ky < 1 || kz2 < 1 || n < 1 || ky > kMaxKy ||
         kz2 > kMaxKz2;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// abar/bbar rows copy as 8-byte pairs (see load_slab)
bool pairs_ok(const float* abar, const float* bbar, int kz2) {
  return kz2 % 2 == 0 &&
         ((reinterpret_cast<uintptr_t>(abar) |
           reinterpret_cast<uintptr_t>(bbar)) & 7) == 0;
}

}  // namespace

extern "C" {

int cf_sf_limits(int* max_ky, int* max_kz2, int* chunk) {
  *max_ky = kMaxKy;
  *max_kz2 = kMaxKz2;
  *chunk = kChunk;
  return 0;
}

// Forward: partial [2, ceil(n / kChunk), kx*ky, kz2] is scratch, a and b
// [kx*ky, kz2] the outputs, all allocated by the caller.
int cf_sf_fwd(const float* cxT, const float* sxT, const float* cyT,
              const float* syT, const float* zq, float* partial, float* a,
              float* b, int kx, int ky, int kz2, int n, void* stream) {
  if (bad_shape(kx, ky, kz2, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const size_t smem = sizeof(float) * ((size_t)2 * ky * kChunk +
                                       (size_t)kChunk * kz2);
  cudaError_t e = allow_smem(sf_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sf_fwd_kernel<<<dim3(kx, n_chunks), kFwdThreads, smem, s>>>(
      cxT, sxT, cyT, syT, zq, partial, kx, ky, kz2, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int m = kx * ky * kz2;
  sf_sum_kernel<<<(2 * m + 255) / 256, 256, 0, s>>>(partial, a, b, n_chunks,
                                                     m);
  return (int)cudaGetLastError();
}

// Backward, phase tables: dcx/dsx [kx, n] and dcy/dsy [ky, n] are outputs.
int cf_sf_bwd_tables(const float* cxT, const float* sxT, const float* cyT,
                     const float* syT, const float* zq, const float* abar,
                     const float* bbar, float* dcx, float* dsx, float* dcy,
                     float* dsy, int kx, int ky, int kz2, int n,
                     void* stream) {
  if (bad_shape(kx, ky, kz2, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kzp = ceil4(kz2), kyp = (ky + kRows - 1) / kRows * kRows;
  const size_t smem = sizeof(float) * ((size_t)2 * Slab{kyp, kzp}.floats() +
                                       (size_t)kzp * kTile +
                                       (size_t)2 * (kyp / kRows) * kTile);
  cudaError_t e = allow_smem(sf_bwd_tables_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sf_bwd_tables_kernel<<<(n + kTile - 1) / kTile, kTile * (kyp / kRows),
                         smem, s>>>(cxT, sxT, cyT, syT, zq, abar, bbar, dcx,
                                    dsx, dcy, dsy, kx, ky, kz2, n,
                                    pairs_ok(abar, bbar, kz2));
  return (int)cudaGetLastError();
}

// Backward, zq: dzq [n, kz2] is the output.
int cf_sf_bwd_zq(const float* cxT, const float* sxT, const float* cyT,
                 const float* syT, const float* abar, const float* bbar,
                 float* dzq, int kx, int ky, int kz2, int n, void* stream) {
  if (bad_shape(kx, ky, kz2, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kzp = ceil4(kz2);
  const size_t smem = sizeof(float) * ((size_t)2 * Slab{ky, kzp}.floats() +
                                       (size_t)4 * ky * kTile);
  cudaError_t e = allow_smem(sf_bwd_zq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sf_bwd_zq_kernel<<<(n + kTile - 1) / kTile,
                     kTile / kZqPer * (kzp / kZqCols), smem, s>>>(
      cxT, sxT, cyT, syT, abar, bbar, dzq, kx, ky, kz2, n,
      pairs_ok(abar, bbar, kz2));
  return (int)cudaGetLastError();
}

}  // extern "C"
