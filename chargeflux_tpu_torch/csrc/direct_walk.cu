// Fused direct-space walk over the cell blocks, for sm_90a: erfc Coulomb
// plus prefactored LJ over every in-cutoff pair, emitting the energy, dE/dx
// and dE/dq in one launch.  Two instantiations: the orthorhombic box ([3]
// edge lengths) and the reduced triclinic lattice ([3, 3] rows), which
// differ only in how a neighbor tile's image offset becomes Cartesian.
// The halo route's slab form (cf_direct_walk_slab, direct_walk_slab_kernel)
// is the same walk over the owned cells of one rank's extended slab, whose
// neighbor table reaches into the halo cells after them.
//
// Replaces chargeflux_tpu/cells.py _concat_fused_walk / _concat_tile (the
// JAX package's hand-VJP XLA walk; the reference did this work in CUDA,
// PBCForce.cu:86-751) and, in slab form, chargeflux_tpu/parallel/halo.py's
// tile_energy under jax.checkpoint.  Same contract: pairs with both
// ids < N and r^2 < rc^2, excluded pairs included (the exclusion
// correction subtracts them), Coulomb qq (1/r - P(r^2)) with P the
// erf(alpha r)/r polynomial in r^2, LJ e_i e_j s^6 (s^6 - 1) with
// s = (hs_i + hs_j) / r.  Every slot of dE/dx and dE/dq is written (a
// sentinel slot holds 0).
//
// What bounds it on the H100.  Not bytes: the seven input columns of the
// 30k main path (8^3 cells, capacity 88) are 1.26 MB and live in L2.  The
// operations are: a distance test per candidate pair (about a dozen
// instructions) and, for the pairs inside the cutoff, a body of about a
// hundred (rsqrt, two Horner chains of 13 coefficients, LJ, five sums).
// A kernel that branches on the cutoff inside one j loop runs that body
// for whole warps in which some three lanes of 32 pass the test (9.6 % of
// the real candidates do): at 30k that is 512 blocks x 4 warps x 27 x 88
// iterations x ~100 = 0.49 G warp instructions, 0.5 ms at the card's full
// rate of one instruction a cycle on each of 132 SMs x 4 schedulers.  So
// the first bound is instructions spent on masked-off lanes; once those
// are gone, the body's arithmetic on the 2 x 2,542,544 ordered in-cutoff
// pairs (about 16 M warp instructions with full lanes) and the distance
// tests that are left.
//
// Design.  One block per i-cell.
//  * Staging drops what can never be in range.  Every warp finds the
//    bounding box of the cell's real i atoms (the positions the block
//    holds, not the cell's nominal bounds: with neighbor reuse atoms drift
//    out of their cells by up to the skin).  The 27 neighbor tiles of the
//    static table are then compacted into shared memory, order kept
//    (ballot and prefix count): sentinel slots go, and so does every j
//    atom farther than the cutoff from that box.  A first sweep counts
//    each tile's survivors, so that a second can pack them densely; what
//    is staged per entry is (x, y, z, q) with the image offset added and
//    (hs, se).  The stage holds 13 capacities' worth of entries; a shell
//    that keeps more is walked in several rounds of whole tiles.
//  * The test is separated from the evaluation.  A thread owns one real
//    i atom (the i slots are compacted too, so sentinels between real
//    slots cost no lane).  Pass 1 runs the distance test over the staged
//    entries, uniform across the warp, and appends the positions of those
//    inside the cutoff to the thread's own list of 16-bit indices in
//    shared memory.  Pass 2 walks the list and evaluates the body, two
//    entries per iteration (two independent Horner chains), so the body
//    runs only for pairs inside the cutoff and the lanes of a warp
//    differ by their list lengths, not by a factor of ten.  When any
//    lane's list might overflow in the next eight tests, the warp
//    evaluates what it has and goes on, so no density, capacity or cutoff
//    makes the kernel wrong.
//  * The card is filled by splitting one cell's staged shell over thread
//    groups, each with a thread per i atom and every n-th chunk of eight
//    entries (so each group sees all 27 tiles, and the lists of a warp's
//    lanes grow alike): a block has four warps per warp of capacity, and a
//    cell whose real atoms fill fewer warps than its capacity forms more
//    groups (at 30k, 62 atoms in 88 slots: six groups of two warps from
//    twelve).  The groups' partial sums are added in a fixed order.
//  * One writer per output, no float atomics, every sum in a fixed order:
//    two launches on the same inputs give the same bits.  The full shell
//    does twice the pair arithmetic of the JAX half shell; the energy
//    takes a factor 1/2, and each block's partial is reduced in a fixed
//    order (the caller sums the partials in a fixed order too).
//
// Prediction, written before the kernel's first timed run: about 27 M warp
// instructions at 30k (per i atom ~950 staged entries x 12 for the test and
// 159 pairs x ~95 for the body), 0.03 ms at the full rate; with 18-27 warps
// per SM and the staging sweeps on top, 0.06-0.12 ms on an NVIDIA H100 80GB
// HBM3 at 700.00 W, against 0.3941 ms for the in-loop branch.
// Reading (chip_smoke.py phase 3, same card and limit): 0.0788 ms, met.
// The first build was slower: each group then took a contiguous share of
// the entries, which is a slab of cells, so the lists of a warp's lanes
// differed by the factor the lists were meant to remove, and the staging
// loads waited on one another.  What is left is spread about evenly over
// the staging, pass 1 and pass 2, at two blocks of twelve warps per SM (80
// registers, 77 KB of shared memory at capacity 88), where the body's
// chains still wait on one another.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxCoef = 16;
constexpr int kMaxCap = 1024;     // one thread per i slot of a group
constexpr int kGroups = 4;        // thread groups of a cell at full capacity
constexpr int kSmallWarps = 3;    // warps of capacity (<= 96 slots) of the
                                  // small instantiation: 384 threads, no
                                  // 64-register ceiling
constexpr int kSmallThreads = 32 * kSmallWarps * kGroups;
constexpr int kStageTiles = 13;   // staged entries per unit of capacity
constexpr int kMaxStage = 4096;   // staged entries at most (96 KB)
constexpr int kChunk = 8;         // pass-1 tests between two list votes
constexpr int kBatch = 4;         // chunks of 32 slots loaded at a time
constexpr float kCullSlack = 1.00001f;  // the cull's r^2 limit over rc^2
constexpr float kFar = 1e18f;     // an idle lane's i position
constexpr float kOne4PiEps0 = 138.935456f;
constexpr unsigned kFull = 0xffffffffu;

// How one capacity is laid out on a block; the kernel reads it back from
// its arguments.
struct Plan {
  int cap_warps;  // warps that hold one thread per slot
  int threads;    // kGroups warps for each of those, 32 warps at most
  int stage;      // staged entries
  int list_cap;   // entries of one thread's list
  // stage, lists, i slots, the keep bits and counts of the 27 tiles, and
  // one energy per warp; the kernel lays them out in this order
  size_t smem() const {
    return (size_t)stage * (sizeof(float4) + sizeof(float2)) +
           (size_t)list_cap * threads * sizeof(unsigned short) +
           (size_t)cap_warps * 32 * sizeof(unsigned short) +
           (size_t)(27 * cap_warps + 27 + 32) * sizeof(int);
  }
};

Plan make_plan(int cap) {
  Plan p;
  p.cap_warps = (cap + 31) / 32;
  p.threads = 32 * (kGroups * p.cap_warps < 32 ? kGroups * p.cap_warps : 32);
  p.stage = kStageTiles * cap < kMaxStage ? kStageTiles * cap : kMaxStage;
  p.list_cap = p.threads <= kSmallThreads ? 64 : 32;
  return p;
}

struct Box6 {
  float lox, loy, loz, hix, hiy, hiz;
};

struct Acc {
  float e, gx, gy, gz, dq;
};

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fmaf_rn(dx, dx, __fmaf_rn(dy, dy, dz * dz));
}

// Whether a real atom at (px, py, pz), image offset added, is staged: it
// lies within the cutoff (and a little more) of the i atoms' bounding box.
__device__ __forceinline__ bool box_keep(float px, float py, float pz,
                                         const Box6& b, float cull2) {
  const float dx = fmaxf(fmaxf(b.lox - px, px - b.hix), 0.0f);
  const float dy = fmaxf(fmaxf(b.loy - py, py - b.hiy), 0.0f);
  const float dz = fmaxf(fmaxf(b.loz - pz, pz - b.hiz), 0.0f);
  return dist2(dx, dy, dz) < cull2;
}

// One in-cutoff pair: its energy e, f = (dE/dr) / r and the Coulomb
// kernel times 1/(4 pi eps0) (the dE/dq term over q_j).
template <int NC>
__device__ __forceinline__ void pair_terms(float r2, float qj, float hsj,
                                           float sej, float kqi, float hsi,
                                           float sei, const float (&cf)[NC],
                                           float ws, float& e, float& f,
                                           float& ec) {
  const float inv_r = rsqrtf(r2);
  const float u = inv_r * inv_r;
  // P(w) and dP/dw by dual Horner in w = r2 * ws - 1 (ops/erfc.py); the
  // coefficients past the polynomial's own are 0 and leave both exact
  const float w = r2 * ws - 1.0f;
  float p = cf[NC - 1];
  float d = 0.0f;
#pragma unroll
  for (int t = NC - 2; t >= 0; --t) {
    d = d * w + p;
    p = p * w + cf[t];
  }
  const float kern = inv_r - p;
  const float qq = kqi * qj;
  const float dcoul_over_r = -qq * (u * inv_r + 2.0f * (d * ws));
  const float sg = (hsi + hsj) * inv_r;
  const float sg2 = sg * sg;
  const float sg6 = sg2 * sg2 * sg2;
  const float epr = sei * sej;
  e = qq * kern + epr * sg6 * (sg6 - 1.0f);
  f = dcoul_over_r - epr * sg6 * (12.0f * sg6 - 6.0f) * u;
  ec = kern * kOne4PiEps0;
}

// Pass 2: the body over one thread's list, in list order, two entries per
// iteration.  lp points at the thread's first entry; entries are `stride`
// apart.
template <int NC>
__device__ __forceinline__ void evaluate(
    const float4* __restrict__ sA, const float2* __restrict__ sB,
    const unsigned short* lp, int stride, int cnt, float xi, float yi,
    float zi, float kqi, float hsi, float sei, const float (&cf)[NC],
    float ws, Acc& acc) {
  int k = 0;
  for (; k + 1 < cnt; k += 2) {
    const int j0 = lp[k * stride];
    const int j1 = lp[(k + 1) * stride];
    const float4 a0 = sA[j0];
    const float4 a1 = sA[j1];
    const float2 b0 = sB[j0];
    const float2 b1 = sB[j1];
    const float dx0 = xi - a0.x, dy0 = yi - a0.y, dz0 = zi - a0.z;
    const float dx1 = xi - a1.x, dy1 = yi - a1.y, dz1 = zi - a1.z;
    float e0, f0, c0, e1, f1, c1;
    pair_terms<NC>(dist2(dx0, dy0, dz0), a0.w, b0.x, b0.y, kqi, hsi, sei, cf,
                   ws, e0, f0, c0);
    pair_terms<NC>(dist2(dx1, dy1, dz1), a1.w, b1.x, b1.y, kqi, hsi, sei, cf,
                   ws, e1, f1, c1);
    acc.e += e0;
    acc.e += e1;
    acc.gx += f0 * dx0;
    acc.gx += f1 * dx1;
    acc.gy += f0 * dy0;
    acc.gy += f1 * dy1;
    acc.gz += f0 * dz0;
    acc.gz += f1 * dz1;
    acc.dq += c0 * a0.w;
    acc.dq += c1 * a1.w;
  }
  if (k < cnt) {
    const int j0 = lp[k * stride];
    const float4 a0 = sA[j0];
    const float2 b0 = sB[j0];
    const float dx0 = xi - a0.x, dy0 = yi - a0.y, dz0 = zi - a0.z;
    float e0, f0, c0;
    pair_terms<NC>(dist2(dx0, dy0, dz0), a0.w, b0.x, b0.y, kqi, hsi, sei, cf,
                   ws, e0, f0, c0);
    acc.e += e0;
    acc.gx += f0 * dx0;
    acc.gy += f0 * dy0;
    acc.gz += f0 * dz0;
    acc.dq += c0 * a0.w;
  }
}

// The kernels' parameters, and the names that pass them on.
#define WALK_PARAMS                                                        \
  const float *__restrict__ bx, const float *__restrict__ by,              \
      const float *__restrict__ bz, const float *__restrict__ bq,          \
      const float *__restrict__ bhs, const float *__restrict__ bse,        \
      const int *__restrict__ ids, const int *__restrict__ nbr,            \
      const int *__restrict__ img, const float *__restrict__ box,          \
      const float *__restrict__ coef, int ncoef, float ws, float cut2,     \
      int n_atoms, int cap, int stage, int list_cap,                       \
      float *__restrict__ e_part, float *__restrict__ grad,                \
      float *__restrict__ dq_out, int n_slots
#define WALK_ARGS                                                          \
  bx, by, bz, bq, bhs, bse, ids, nbr, img, box, coef, ncoef, ws, cut2,     \
      n_atoms, cap, stage, list_cap, e_part, grad, dq_out, n_slots

// One i-cell's walk.  TRICLINIC: the box is the [3, 3] row-major reduced
// lower-triangular lattice B, and a neighbor tile's integer image offset
// im turns into the lattice rows im[0] B[0] + im[1] B[1] + im[2] B[2];
// otherwise the box is the [3] edge lengths and the offset im[k] L[k].
// Everything after the offset (the cull against the i atoms' bounding box,
// the distance tests, the pair terms) works in Cartesian space, so it
// holds for a sheared box as it is.
template <int NC, bool TRICLINIC>
__device__ __forceinline__ void walk_cell(WALK_PARAMS) {
  extern __shared__ float4 smem4[];
  float4* sA = smem4;                                    // x, y, z, q
  float2* sB = reinterpret_cast<float2*>(sA + stage);    // hs, se
  unsigned short* lists = reinterpret_cast<unsigned short*>(sB + stage);
  unsigned short* islot = lists + list_cap * blockDim.x;
  const int cap_warps = (cap + 31) >> 5;
  // one keep bit per slot of each tile, the tiles' kept counts, a sum per
  // warp
  unsigned* keep_mask = reinterpret_cast<unsigned*>(islot + 32 * cap_warps);
  int* tile_cnt = reinterpret_cast<int*>(keep_mask + 27 * cap_warps);
  float* wsum = reinterpret_cast<float*>(tile_cnt + 27);

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = blockDim.x >> 5;
  const int cell0 = c * cap;
  const unsigned lt_mask = (1u << lane) - 1u;

  // Lane s < 27 of every warp holds neighbor tile s: its first slot and
  // its periodic image offset.  All global loads of the staging are started
  // kBatch chunks of 32 slots at a time, none behind another's result.
  int my_tile0 = 0;
  float my_ox = 0.0f, my_oy = 0.0f, my_oz = 0.0f;
  if (lane < 27) {
    const int* im = img + (c * 27 + lane) * 3;
    my_tile0 = nbr[c * 27 + lane] * cap;
    if (TRICLINIC) {
      my_ox = im[0] * box[0] + im[1] * box[3] + im[2] * box[6];
      my_oy = im[1] * box[4] + im[2] * box[7];
      my_oz = im[2] * box[8];
    } else {
      my_ox = im[0] * box[0];
      my_oy = im[1] * box[1];
      my_oz = im[2] * box[2];
    }
  }

  float cf[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) cf[t] = t < ncoef ? coef[t] : 0.0f;

  // The real i atoms of the cell: their count and bounding box in every
  // warp, their slots (rank -> slot, ascending) written by warp 0.
  Box6 b = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  int n_real = 0;
  for (int k0 = 0; k0 < cap; k0 += 32 * kBatch) {
    int id[kBatch];
    float px[kBatch], py[kBatch], pz[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + 32 * u + lane;
      const bool in = k < cap;
      id[u] = in ? ids[cell0 + k] : n_atoms;
      px[u] = in ? bx[cell0 + k] : 0.0f;
      py[u] = in ? by[cell0 + k] : 0.0f;
      pz[u] = in ? bz[cell0 + k] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool real = id[u] < n_atoms;
      const unsigned m = __ballot_sync(kFull, real);
      if (real) {
        b.lox = fminf(b.lox, px[u]);
        b.hix = fmaxf(b.hix, px[u]);
        b.loy = fminf(b.loy, py[u]);
        b.hiy = fmaxf(b.hiy, py[u]);
        b.loz = fminf(b.loz, pz[u]);
        b.hiz = fmaxf(b.hiz, pz[u]);
        if (warp == 0)
          islot[n_real + __popc(m & lt_mask)] =
              (unsigned short)(k0 + 32 * u + lane);
      }
      n_real += __popc(m);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    b.lox = fminf(b.lox, __shfl_xor_sync(kFull, b.lox, o));
    b.loy = fminf(b.loy, __shfl_xor_sync(kFull, b.loy, o));
    b.loz = fminf(b.loz, __shfl_xor_sync(kFull, b.loz, o));
    b.hix = fmaxf(b.hix, __shfl_xor_sync(kFull, b.hix, o));
    b.hiy = fmaxf(b.hiy, __shfl_xor_sync(kFull, b.hiy, o));
    b.hiz = fmaxf(b.hiz, __shfl_xor_sync(kFull, b.hiz, o));
  }
  const float cull2 = cut2 * kCullSlack;

  // First sweep: which slots of each neighbor tile are staged (one bit a
  // slot) and how many.  The self tile keeps every real atom, so that its
  // staged order is the i atoms' order.
  for (int s = warp; s < 27; s += nwarps) {
    const int tile0 = __shfl_sync(kFull, my_tile0, s);
    const float ox = __shfl_sync(kFull, my_ox, s);
    const float oy = __shfl_sync(kFull, my_oy, s);
    const float oz = __shfl_sync(kFull, my_oz, s);
    int n = 0;
    for (int k0 = 0; k0 < cap; k0 += 32 * kBatch) {
      int id[kBatch];
      float px[kBatch], py[kBatch], pz[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + 32 * u + lane;
        const bool in = k < cap;
        id[u] = in ? ids[tile0 + k] : n_atoms;
        px[u] = in ? bx[tile0 + k] : 0.0f;
        py[u] = in ? by[tile0 + k] : 0.0f;
        pz[u] = in ? bz[tile0 + k] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool keep =
            id[u] < n_atoms &&
            (s == 13 || box_keep(px[u] + ox, py[u] + oy, pz[u] + oz, b, cull2));
        const unsigned m = __ballot_sync(kFull, keep);
        if (lane == 0 && k0 + 32 * u < cap)
          keep_mask[s * cap_warps + (k0 >> 5) + u] = m;
        n += __popc(m);
      }
    }
    if (lane == 0) tile_cnt[s] = n;
  }
  __syncthreads();

  // This thread's i atom: the real atoms fill i_warps warps, the block
  // forms as many groups of that size as it has warps for, and thread t
  // of group g owns the t-th real slot.
  const int i_warps = n_real > 32 ? (n_real + 31) >> 5 : 1;
  const int groups = nwarps / i_warps;
  const int g = warp / i_warps;
  const int t = ((warp - g * i_warps) << 5) + lane;
  const bool warp_act = g < groups && t - lane < n_real;
  const bool act = warp_act && t < n_real;
  const int si = cell0 + (act ? (int)islot[t] : 0);
  const float xi = act ? bx[si] : kFar;
  const float yi = act ? by[si] : kFar;
  const float zi = act ? bz[si] : kFar;
  const float kqi = kOne4PiEps0 * bq[si];
  const float hsi = bhs[si], sei = bse[si];

  Acc acc = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int s0 = 0; s0 < 27;) {
    // this round: the tiles [s0, s1) that fit the stage together (one
    // tile always does: it keeps at most `cap` entries), m entries
    int s1 = s0, m = 0, self_base = -1;
    while (s1 < 27 && m + tile_cnt[s1] <= stage) {
      if (s1 == 13) self_base = m;
      m += tile_cnt[s1];
      ++s1;
    }
    // Second sweep: the round's tiles packed in (tile, slot) order.
    for (int s = s0 + warp; s < s1; s += nwarps) {
      int at = 0;
      for (int v = s0; v < s; ++v) at += tile_cnt[v];
      const int tile0 = __shfl_sync(kFull, my_tile0, s);
      const float ox = __shfl_sync(kFull, my_ox, s);
      const float oy = __shfl_sync(kFull, my_oy, s);
      const float oz = __shfl_sync(kFull, my_oz, s);
      for (int k0 = 0; k0 < cap; k0 += 32 * kBatch) {
        unsigned mk[kBatch];
        float4 a[kBatch];
        float2 h[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = k0 + 32 * u + lane;
          mk[u] = k0 + 32 * u < cap
                      ? keep_mask[s * cap_warps + (k0 >> 5) + u] : 0u;
          const bool keep = (mk[u] >> lane) & 1u;
          a[u].x = keep ? bx[tile0 + k] : 0.0f;
          a[u].y = keep ? by[tile0 + k] : 0.0f;
          a[u].z = keep ? bz[tile0 + k] : 0.0f;
          a[u].w = keep ? bq[tile0 + k] : 0.0f;
          h[u].x = keep ? bhs[tile0 + k] : 0.0f;
          h[u].y = keep ? bse[tile0 + k] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if ((mk[u] >> lane) & 1u) {
            const int w = at + __popc(mk[u] & lt_mask);
            sA[w] = make_float4(a[u].x + ox, a[u].y + oy, a[u].z + oz, a[u].w);
            sB[w] = h[u];
          }
          at += __popc(mk[u]);
        }
      }
    }
    __syncthreads();

    if (warp_act) {
      // this group's share of the entries: every groups-th chunk of
      // kChunk, so that each group sees all 27 tiles and the lists of a
      // warp's lanes grow alike (a contiguous share would be a slab of
      // cells, near some i atoms and far from others); the self pair is
      // the entry of the self tile at this thread's rank
      const int self_j = self_base >= 0 ? self_base + t : -1;
      unsigned short* lp = lists + tid;
      int cnt = 0;
      for (int jb = g * kChunk; jb < m; jb += groups * kChunk) {
        if (__any_sync(kFull, cnt + kChunk > list_cap)) {
          evaluate<NC>(sA, sB, lp, nthreads, cnt, xi, yi, zi, kqi, hsi, sei,
                       cf, ws, acc);
          cnt = 0;
        }
        // the index is stored whatever the test says and kept only if it
        // passed: no branch, and cnt < list_cap at every store
        if (jb + kChunk <= m) {
#pragma unroll
          for (int v = 0; v < kChunk; ++v) {
            const float4 a = sA[jb + v];
            const float r2 = dist2(xi - a.x, yi - a.y, zi - a.z);
            lp[cnt * nthreads] = (unsigned short)(jb + v);
            cnt += (r2 < cut2 && jb + v != self_j) ? 1 : 0;
          }
        } else {
          for (int j = jb; j < m; ++j) {
            const float4 a = sA[j];
            const float r2 = dist2(xi - a.x, yi - a.y, zi - a.z);
            lp[cnt * nthreads] = (unsigned short)j;
            cnt += (r2 < cut2 && j != self_j) ? 1 : 0;
          }
        }
      }
      evaluate<NC>(sA, sB, lp, nthreads, cnt, xi, yi, zi, kqi, hsi, sei, cf,
                   ws, acc);
    }
    __syncthreads();  // the stage and the lists are consumed
    s0 = s1;
  }

  // The groups' partial sums, added to group 0's in group order; the
  // lists' memory holds them.
  float* part = reinterpret_cast<float*>(lists);
  if (g > 0 && act) {
    float* p = part + ((g - 1) * i_warps * 32 + t) * 5;
    p[0] = acc.e;
    p[1] = acc.gx;
    p[2] = acc.gy;
    p[3] = acc.gz;
    p[4] = acc.dq;
  }
  __syncthreads();
  float e = 0.0f;
  if (g == 0 && act) {
    for (int h = 1; h < groups; ++h) {
      const float* p = part + ((h - 1) * i_warps * 32 + t) * 5;
      acc.e += p[0];
      acc.gx += p[1];
      acc.gy += p[2];
      acc.gz += p[3];
      acc.dq += p[4];
    }
    grad[si] = acc.gx;
    grad[n_slots + si] = acc.gy;
    grad[2 * n_slots + si] = acc.gz;
    dq_out[si] = acc.dq;
    e = acc.e;
  }
  for (int k = tid; k < cap; k += nthreads) {
    if (!((keep_mask[13 * cap_warps + (k >> 5)] >> (k & 31)) & 1u)) {
      grad[cell0 + k] = 0.0f;
      grad[n_slots + cell0 + k] = 0.0f;
      grad[2 * n_slots + cell0 + k] = 0.0f;
      dq_out[cell0 + k] = 0.0f;
    }
  }
  // the block's energy: a fixed shuffle tree per warp, then the warps in
  // order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(kFull, e, o);
  if (lane == 0) wsum[warp] = e;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.0f;
    for (int w = 0; w < nwarps; ++w) sum += wsum[w];
    e_part[c] = 0.5f * sum;
  }
}

// The two instantiations have names of their own, so that a profiler
// trace tells them apart.
template <int NC, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    direct_walk_kernel(WALK_PARAMS) {
  walk_cell<NC, false>(WALK_ARGS);
}

template <int NC, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    direct_walk_tri_kernel(WALK_PARAMS) {
  walk_cell<NC, true>(WALK_ARGS);
}

// The halo route's slab form (cf_direct_walk_slab): the same walk over the
// owned i-cells of an extended slab, either box.
template <int NC, int MAXT, int MINB, bool TRICLINIC>
__global__ void __launch_bounds__(MAXT, MINB)
    direct_walk_slab_kernel(WALK_PARAMS) {
  walk_cell<NC, TRICLINIC>(WALK_ARGS);
}

// The arguments of cf_direct_walk, as the launches pass them on.
struct WalkArgs {
  const float *x, *y, *z, *q, *hs, *se;
  const int *ids, *nbr, *img;
  const float *box, *coef;
  int ncoef;
  float ws, cut2;
  int n_atoms, n_cells, cap;
  float *e_part, *grad, *dq;
};

template <int NC, int MAXT, int MINB>
cudaError_t launch(const Plan& p, const WalkArgs& a, bool triclinic,
                   bool slab, cudaStream_t s) {
  auto kernel =
      slab ? (triclinic ? direct_walk_slab_kernel<NC, MAXT, MINB, true>
                        : direct_walk_slab_kernel<NC, MAXT, MINB, false>)
           : (triclinic ? direct_walk_tri_kernel<NC, MAXT, MINB>
                        : direct_walk_kernel<NC, MAXT, MINB>);
  const size_t smem = p.smem();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.n_cells, p.threads, smem, s>>>(
      a.x, a.y, a.z, a.q, a.hs, a.se, a.ids, a.nbr, a.img, a.box, a.coef,
      a.ncoef, a.ws, a.cut2, a.n_atoms, a.cap, p.stage, p.list_cap, a.e_part,
      a.grad, a.dq, a.n_cells * a.cap);
  return cudaGetLastError();
}

// The instantiation for this capacity and coefficient count.
int run_walk(const WalkArgs& a, bool triclinic, bool slab, cudaStream_t s) {
  if (a.cap < 1 || a.cap > kMaxCap || a.ncoef < 1 || a.ncoef > kMaxCoef ||
      a.n_cells < 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(a.cap);
  // the polynomial of ops/erfc.py has 13 coefficients; any other count
  // runs the 16-coefficient chain on zero-padded coefficients
  if (p.cap_warps <= kSmallWarps)
    return (int)(a.ncoef == 13
                     ? launch<13, kSmallThreads, 2>(p, a, triclinic, slab, s)
                     : launch<kMaxCoef, kSmallThreads, 2>(p, a, triclinic,
                                                          slab, s));
  return (int)(a.ncoef == 13
                   ? launch<13, 1024, 1>(p, a, triclinic, slab, s)
                   : launch<kMaxCoef, 1024, 1>(p, a, triclinic, slab, s));
}

}  // namespace

extern "C" {

// The most coefficients and the largest capacity the kernel takes.
int cf_walk_limits(int* max_coef, int* max_cap) {
  *max_coef = kMaxCoef;
  *max_cap = kMaxCap;
  return 0;
}

// Blocks x..se and ids are [n_cells, cap]; nbr [n_cells, 27] int32, img
// [n_cells, 27, 3] int32 image offsets in lattice units; box [3] edge
// lengths, or with `triclinic` the [3, 3] row-major reduced lattice; coef
// [ncoef] ascending monomial coefficients.  Outputs: e_part [n_cells],
// grad [3, n_cells * cap], dq [n_cells * cap].
int cf_direct_walk(const float* x, const float* y, const float* z,
                   const float* q, const float* hs, const float* se,
                   const int* ids, const int* nbr, const int* img,
                   const float* box, const float* coef, int ncoef, float ws,
                   float cut2, int n_atoms, int n_cells, int cap,
                   int triclinic, float* e_part, float* grad, float* dq,
                   void* stream) {
  const WalkArgs a = {x,    y,     z,    q,       hs,      se,  ids,
                      nbr,  img,   box,  coef,    ncoef,   ws,  cut2,
                      n_atoms,     n_cells,       cap,     e_part,
                      grad, dq};
  return run_walk(a, triclinic != 0, false, static_cast<cudaStream_t>(stream));
}

// The halo route's extended slab: blocks x..se and ids are [n_ext, cap],
// the n_own owned cells first, then the halo cells exchanged from the
// neighbor ranks; nbr [n_own, 27] and img [n_own, 27, 3] index the
// extended slab.  Only the owned cells are i-cells: the launch has n_own
// blocks, every input is read through cell0 = i-cell * cap (an owned
// cell) or through nbr, and the outputs are e_part [n_own], grad
// [3, n_own * cap] and dq [n_own * cap] on the owned slots.
int cf_direct_walk_slab(const float* x, const float* y, const float* z,
                        const float* q, const float* hs, const float* se,
                        const int* ids, const int* nbr, const int* img,
                        const float* box, const float* coef, int ncoef,
                        float ws, float cut2, int n_atoms, int n_own,
                        int n_ext, int cap, int triclinic, float* e_part,
                        float* grad, float* dq, void* stream) {
  if (n_ext < n_own) return (int)cudaErrorInvalidValue;
  const WalkArgs a = {x,    y,     z,    q,       hs,      se,  ids,
                      nbr,  img,   box,  coef,    ncoef,   ws,  cut2,
                      n_atoms,     n_own,         cap,     e_part,
                      grad, dq};
  return run_walk(a, triclinic != 0, true, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
