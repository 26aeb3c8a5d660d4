// Fused direct-space walk over the cell blocks, for sm_90a: erfc Coulomb
// plus prefactored LJ over every in-cutoff pair, emitting the energy, dE/dx
// and dE/dq in one pass.
//
// Replaces chargeflux_tpu/cells.py _concat_fused_walk / _concat_tile (the
// JAX package's hand-VJP XLA walk; the reference did this work in CUDA,
// PBCForce.cu:86-751).  Same contract: pairs with both ids < N and
// r^2 < rc^2, excluded pairs included (the exclusion correction subtracts
// them), Coulomb qq (1/r - P(r^2)) with P the erf(alpha r)/r polynomial in
// r^2, LJ e_i e_j s^6 (s^6 - 1) with s = (hs_i + hs_j) / r.
//
// What bounds it on the H100.  At the 30k main path (8^3 cells, capacity
// 88) the full shell tests 512 * 27 * 88 * 88 = 107 M pairs, about 10 % of
// them inside the cutoff; that is some 2 G instructions, tens of
// microseconds of issue across 132 SMs.  The inputs (7 x 180 KB) live in
// L2 and each tile is read once per block into shared memory, so bytes do
// not bound it; latency does: 4-warp blocks (a power of two >= the
// capacity, 128 threads for 88 slots) and one dependent j loop per thread.
//
// Design.  One block per i-cell, one thread per i slot.  The 27 neighbor
// cells come from the static neighbor table with their periodic image
// offsets in box units; each neighbor tile is staged in shared memory with
// its image offset added.  Every i accumulates its own gradient, dE/dq and
// energy over the full shell, so no thread writes another's output: no
// atomics, and two launches on the same inputs give the same bits.  The
// full shell does twice the pair arithmetic of the JAX half shell; the
// energy takes a factor 1/2, and each block's partial is reduced in a fixed
// order (the caller sums the partials in a fixed order too).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCoef = 16;
constexpr float kOne4PiEps0 = 138.935456f;

__global__ void direct_walk_kernel(
    const float* __restrict__ bx, const float* __restrict__ by,
    const float* __restrict__ bz, const float* __restrict__ bq,
    const float* __restrict__ bhs, const float* __restrict__ bse,
    const int* __restrict__ ids, const int* __restrict__ nbr,
    const int* __restrict__ img, const float* __restrict__ box,
    const float* __restrict__ coef, int ncoef, float ws, float cut2,
    int n_atoms, int cap, float* __restrict__ e_part,
    float* __restrict__ grad, float* __restrict__ dq_out, int n_slots) {
  extern __shared__ float tile[];  // 6 float columns + 1 int column of cap
  float* sx = tile;
  float* sy = sx + cap;
  float* sz = sy + cap;
  float* sq = sz + cap;
  float* shs = sq + cap;
  float* sse = shs + cap;
  int* sid = reinterpret_cast<int*>(sse + cap);
  __shared__ float red[1024];
  __shared__ float cf[kMaxCoef];

  const int c = blockIdx.x;
  const int i = threadIdx.x;
  if (i < ncoef) cf[i] = coef[i];
  const float L0 = box[0], L1 = box[1], L2 = box[2];

  const bool in_cell = i < cap;
  const int si = c * cap + (in_cell ? i : 0);
  const int id_i = in_cell ? ids[si] : n_atoms;
  const bool act = id_i < n_atoms;
  const float xi = bx[si], yi = by[si], zi = bz[si];
  const float kqi = kOne4PiEps0 * bq[si];
  const float hsi = bhs[si], sei = bse[si];

  float e = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f, dq = 0.0f;
  for (int s = 0; s < 27; ++s) {
    const int cj = nbr[c * 27 + s];
    const int* im = img + (c * 27 + s) * 3;
    const float ox = im[0] * L0, oy = im[1] * L1, oz = im[2] * L2;
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < cap; k += blockDim.x) {
      const int sj = cj * cap + k;
      sx[k] = bx[sj] + ox;
      sy[k] = by[sj] + oy;
      sz[k] = bz[sj] + oz;
      sq[k] = bq[sj];
      shs[k] = bhs[sj];
      sse[k] = bse[sj];
      sid[k] = ids[sj];
    }
    __syncthreads();
    if (!act) continue;
    const bool self_cell = cj == c;
    for (int j = 0; j < cap; ++j) {
      if (sid[j] >= n_atoms || (self_cell && j == i)) continue;
      const float dx = xi - sx[j];
      const float dy = yi - sy[j];
      const float dz = zi - sz[j];
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (!(r2 < cut2)) continue;
      const float inv_r = rsqrtf(r2);
      const float u = inv_r * inv_r;
      // P(w) and dP/dw by dual Horner in w = r2 * ws - 1 (ops/erfc.py)
      const float w = r2 * ws - 1.0f;
      float p = cf[ncoef - 1];
      float d = 0.0f;
      for (int t = ncoef - 2; t >= 0; --t) {
        d = d * w + p;
        p = p * w + cf[t];
      }
      const float kern = inv_r - p;
      const float qq = kqi * sq[j];
      const float coul = qq * kern;
      const float dcoul_over_r = -qq * (u * inv_r + 2.0f * (d * ws));
      const float sg = (hsi + shs[j]) * inv_r;
      const float sg2 = sg * sg;
      const float sg6 = sg2 * sg2 * sg2;
      const float epr = sei * sse[j];
      e += coul + epr * sg6 * (sg6 - 1.0f);
      const float f = dcoul_over_r - epr * sg6 * (12.0f * sg6 - 6.0f) * u;
      gx += f * dx;
      gy += f * dy;
      gz += f * dz;
      dq += (kern * kOne4PiEps0) * sq[j];
    }
  }
  if (in_cell) {
    grad[si] = gx;
    grad[n_slots + si] = gy;
    grad[2 * n_slots + si] = gz;
    dq_out[si] = dq;
  }
  // fixed-order tree reduction of the block's energy
  red[threadIdx.x] = e;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) e_part[c] = 0.5f * red[0];
}

}  // namespace

extern "C" {

int cf_walk_limits(int* max_coef, int* max_threads) {
  *max_coef = kMaxCoef;
  *max_threads = 1024;
  return 0;
}

// Blocks x..se and ids are [n_cells, cap]; nbr [n_cells, 27] int32, img
// [n_cells, 27, 3] int32 image offsets in box units; box [3]; coef [ncoef]
// ascending monomial coefficients.  Outputs: e_part [n_cells], grad
// [3, n_cells * cap], dq [n_cells * cap].
int cf_direct_walk(const float* x, const float* y, const float* z,
                   const float* q, const float* hs, const float* se,
                   const int* ids, const int* nbr, const int* img,
                   const float* box, const float* coef, int ncoef, float ws,
                   float cut2, int n_atoms, int n_cells, int cap,
                   float* e_part, float* grad, float* dq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int threads = 32;
  while (threads < cap) threads *= 2;  // power of two for the reduction
  const size_t smem = (size_t)cap * (6 * sizeof(float) + sizeof(int));
  direct_walk_kernel<<<n_cells, threads, smem, s>>>(
      x, y, z, q, hs, se, ids, nbr, img, box, coef, ncoef, ws, cut2,
      n_atoms, cap, e_part, grad, dq, n_cells * cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
