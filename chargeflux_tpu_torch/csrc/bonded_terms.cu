// The harmonic bonds and angles of one molecule template for sm_90a,
// forward and backward.  A template is `count` copies of a `stride`-atom
// molecule on atoms [offset, offset + count * stride), each with the same
// local rows: `n_bonds` bonds (l1, l2) and then `n_angles` angles (l1, l2,
// l3; l2 the vertex) in one int32 table.  Each copy carries its own k, r0
// and theta0: the row t of molecule m reads entry b0 + m * n_bonds + t of
// bond_k and bond_r0 (a0 + m * n_angles + t of angle_k and angle_theta0),
// as BondedParams stores them.  With the minimum-image displacement in a
// [3] box (or none, pbc = 0):
//   bond:  d = x_l2 - x_l1, r = |d|,         e = 1/2 k (r - r0)^2
//   angle: d21 = x_l1 - x_l2, d23 = x_l3 - x_l2,
//          c = d21.d23 / (|d21| |d23|), theta = acos(clamp(c, -1, 1)),
//                                           e = 1/2 k (theta - theta0)^2,
// the arithmetic of the plain chain in ops/bonded_terms.py (_bond_e and
// _angle_e on a template's slices).  The forward writes E = sum of e; the
// backward writes ct dE/dx [N, 3] (zero outside the template's atoms), the
// closed-form derivative of the same e, so forces stay the exact gradient
// of the computed energy.  Where the clamp is active (c rounded past +-1)
// the angle passes no gradient through theta, as autograd's clamp does.
// No cotangent for k, r0, theta0 or the box: nothing differentiates
// through them on this route (npt._box_grad_potential's box requires grad
// and takes the plain chain).
//
// Replaces no Pallas kernel.  The JAX package evaluates the same rows as
// jnp slices (bonded.bonded_energy), which XLA fuses into a loop; eager
// PyTorch ran each as its own op, some 146 compute graph nodes a forward
// plus backward whatever N (~0.25 ms of an MD step at 98k atoms, each
// node ~1.7 us over 32,768 elements), four times an r-RESPA outer step.
//
// What bounds it on the H100: nothing but latency.  At 32,768 waters the
// forward reads 15 words a molecule (2.0 MB, 0.6 us at 3.35 TB/s) for
// ~121 flops (4.0 MFLOP, 0.06 us of the f32 rate); the backward reads the
// same and writes 9 words a molecule (3.1 MB, 0.9 us).  So each pass is
// one launch over the molecules that reads every word once into registers
// (the forward adds a one-block launch for its final sum):
//  * forward: one thread per molecule evaluates its rows in the rows'
//    order; the block sums its threads' energies in a fixed tree in f64
//    into one partial per block, and a one-block pass sums the partials in
//    a fixed order (no float atomics: two launches give the same bits);
//  * backward: one thread per molecule takes its atoms in turn, recomputes
//    the rows that hold each and writes that atom's gradient once: a
//    template's molecules own disjoint atoms, so nothing is scattered; the
//    same threads write the zeros of the atoms outside the template, so the
//    [N, 3] output needs no memset;
//  * nothing is masked by a select that could swallow a NaN: a NaN
//    position gives a NaN energy and NaN gradients on its molecule, as the
//    plain chain does.
//
// Prediction, written before the kernels' first timed run: ~3-6 us each at
// 32,768 waters (latency bound), in place of ~0.25 ms per evaluation on an
// NVIDIA H100 80GB HBM3 at 700 W.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Template {
  int offset, stride, count, n_bonds, n_angles, n_atoms, b0, a0, pbc;

  __host__ __device__ long long end() const {
    return static_cast<long long>(offset) +
           static_cast<long long>(count) * stride;
  }
  bool valid() const {
    return offset >= 0 && stride >= 2 && count >= 1 && n_bonds >= 0 &&
           n_angles >= 0 && n_bonds + n_angles >= 1 && b0 >= 0 && a0 >= 0 &&
           end() <= n_atoms;
  }
  // the atoms outside the template, whose gradient the backward zeroes
  __host__ __device__ int n_outside() const {
    return n_atoms - count * stride;
  }
  unsigned fwd_blocks() const {
    return static_cast<unsigned>((count + kThreads - 1) / kThreads);
  }
  unsigned bwd_blocks() const {
    const int n = count > n_outside() ? count : n_outside();
    return static_cast<unsigned>((n + kThreads - 1) / kThreads);
  }
};

struct Rows {
  const float* __restrict__ bond_k;
  const float* __restrict__ bond_r0;
  const float* __restrict__ angle_k;
  const float* __restrict__ angle_t0;
  const int* __restrict__ table;  // n_bonds pairs, then n_angles triples
};

// The displacement b - a, minimum image in the box [3] with pbc
// (pairs.delta_periodic: d - box * floor(d / box + 0.5), the product
// rounded on its own as the plain chain's is).
__device__ __forceinline__ void displacement(const float* __restrict__ x,
                                             long long a, long long b,
                                             const float (&box)[3], int pbc,
                                             float (&d)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = x[3 * b + c] - x[3 * a + c];
    d[c] = pbc ? v - __fmul_rn(box[c], floorf(v / box[c] + 0.5f)) : v;
  }
}

__device__ __forceinline__ float norm2(const float (&d)[3]) {
  return d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
}

// The bond's energy and, with GRAD, dE/dd (d = x_l2 - x_l1).
template <bool GRAD>
__device__ __forceinline__ float bond_term(const float (&d)[3], float k,
                                           float r0, float (&g)[3]) {
  const float r = sqrtf(norm2(d));
  const float dr = r - r0;
  if (GRAD) {
    const float s = (k * dr) / r;
#pragma unroll
    for (int c = 0; c < 3; ++c) g[c] = s * d[c];
  }
  return 0.5f * (k * (dr * dr));
}

// The angle's energy and, with GRAD, dE/dd21 and dE/dd23.  The clamp
// passes the gradient where c lies in [-1, 1] and none elsewhere (a NaN c
// included, as autograd's clamp); a NaN still reaches the gradients
// through the products with 1 / (|d21| |d23|).
template <bool GRAD>
__device__ __forceinline__ float angle_term(const float (&d21)[3],
                                            const float (&d23)[3], float k,
                                            float theta0, float (&g21)[3],
                                            float (&g23)[3]) {
  const float s21 = norm2(d21), s23 = norm2(d23);
  const float den = sqrtf(s21) * sqrtf(s23);
  const float dot = d21[0] * d23[0] + d21[1] * d23[1] + d21[2] * d23[2];
  const float c = dot / den;
  const bool inside = c >= -1.f && c <= 1.f;
  const float cc = c < -1.f ? -1.f : (c > 1.f ? 1.f : c);
  const float dt = acosf(cc) - theta0;
  if (GRAD) {
    const float gc = inside ? (k * dt) * -rsqrtf(1.f - cc * cc) : 0.f;
    const float a = gc / den;
    const float b21 = gc * c / s21, b23 = gc * c / s23;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g21[i] = a * d23[i] - b21 * d21[i];
      g23[i] = a * d21[i] - b23 * d23[i];
    }
  }
  return 0.5f * (k * (dt * dt));
}

__global__ void __launch_bounds__(kThreads)
bonded_terms_fwd_kernel(const float* __restrict__ x, Rows rw,
                        const float* __restrict__ box, Template tp,
                        double* __restrict__ partials) {
  __shared__ double red[kThreads];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  double acc = 0.0;
  if (m < tp.count) {
    float bx[3] = {0.f, 0.f, 0.f};
    if (tp.pbc) {
      bx[0] = box[0];
      bx[1] = box[1];
      bx[2] = box[2];
    }
    const long long base =
        tp.offset + static_cast<long long>(m) * tp.stride;
    const long long pb = tp.b0 + static_cast<long long>(m) * tp.n_bonds;
    const long long pa = tp.a0 + static_cast<long long>(m) * tp.n_angles;
    float g[3], h[3];
    for (int t = 0; t < tp.n_bonds; ++t) {
      float d[3];
      displacement(x, base + rw.table[2 * t], base + rw.table[2 * t + 1], bx,
                   tp.pbc, d);
      acc += static_cast<double>(
          bond_term<false>(d, rw.bond_k[pb + t], rw.bond_r0[pb + t], g));
    }
    const int* ang = rw.table + 2 * tp.n_bonds;
    for (int t = 0; t < tp.n_angles; ++t) {
      const long long v = base + ang[3 * t + 1];
      float d21[3], d23[3];
      displacement(x, v, base + ang[3 * t], bx, tp.pbc, d21);
      displacement(x, v, base + ang[3 * t + 2], bx, tp.pbc, d23);
      acc += static_cast<double>(angle_term<false>(
          d21, d23, rw.angle_k[pa + t], rw.angle_t0[pa + t], g, h));
    }
  }
  red[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
}

// The forward's final pass: the partials summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
bonded_terms_total_kernel(const double* __restrict__ partials, int n,
                          float* __restrict__ energy) {
  __shared__ double red[kThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  red[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *energy = static_cast<float>(red[0]);
}

__global__ void __launch_bounds__(kThreads)
bonded_terms_bwd_kernel(const float* __restrict__ x, Rows rw,
                        const float* __restrict__ box, Template tp,
                        const float* __restrict__ ct,
                        float* __restrict__ g_x) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t < tp.n_outside()) {
    const long long i = t < tp.offset ? t : t + tp.end() - tp.offset;
#pragma unroll
    for (int c = 0; c < 3; ++c) g_x[3 * i + c] = 0.f;
  }
  if (t >= tp.count) return;
  float bx[3] = {0.f, 0.f, 0.f};
  if (tp.pbc) {
    bx[0] = box[0];
    bx[1] = box[1];
    bx[2] = box[2];
  }
  const float scale = *ct;
  const long long base = tp.offset + static_cast<long long>(t) * tp.stride;
  const long long pb = tp.b0 + static_cast<long long>(t) * tp.n_bonds;
  const long long pa = tp.a0 + static_cast<long long>(t) * tp.n_angles;
  const int* ang = rw.table + 2 * tp.n_bonds;
  for (int l = 0; l < tp.stride; ++l) {
    float g[3] = {0.f, 0.f, 0.f};
    for (int r = 0; r < tp.n_bonds; ++r) {
      const int l1 = rw.table[2 * r], l2 = rw.table[2 * r + 1];
      if (l1 != l && l2 != l) continue;
      float d[3], gd[3];
      displacement(x, base + l1, base + l2, bx, tp.pbc, d);
      bond_term<true>(d, rw.bond_k[pb + r], rw.bond_r0[pb + r], gd);
      // d = x_l2 - x_l1: +dE/dd on l2, -dE/dd on l1
      const float s = l == l2 ? 1.f : -1.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) g[c] += s * gd[c];
    }
    for (int r = 0; r < tp.n_angles; ++r) {
      const int l1 = ang[3 * r], l2 = ang[3 * r + 1], l3 = ang[3 * r + 2];
      if (l1 != l && l2 != l && l3 != l) continue;
      float d21[3], d23[3], g21[3], g23[3];
      displacement(x, base + l2, base + l1, bx, tp.pbc, d21);
      displacement(x, base + l2, base + l3, bx, tp.pbc, d23);
      angle_term<true>(d21, d23, rw.angle_k[pa + r], rw.angle_t0[pa + r],
                       g21, g23);
      // d21 = x_l1 - x_l2, d23 = x_l3 - x_l2
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (l == l1) g[c] += g21[c];
        if (l == l3) g[c] += g23[c];
        if (l == l2) g[c] -= g21[c] + g23[c];
      }
    }
    const long long i = base + l;
#pragma unroll
    for (int c = 0; c < 3; ++c) g_x[3 * i + c] = scale * g[c];
  }
}

}  // namespace

extern "C" {

// The threads per block of the forward, so its partials number
// ceil(count / threads).
int cf_bonded_limits(int* threads) {
  *threads = kThreads;
  return 0;
}

// x [n_atoms, 3] f32; bond_k, bond_r0 [>= b0 + count * n_bonds] and
// angle_k, angle_theta0 [>= a0 + count * n_angles] f32; box [3] f32 (read
// only with pbc); rows [2 n_bonds + 3 n_angles] int32 local indices;
// partials [ceil(count / threads)] f64 scratch; writes E to energy [1] f32.
int cf_bonded_fwd(const float* x, const float* bond_k, const float* bond_r0,
                  const float* angle_k, const float* angle_theta0,
                  const float* box, const int* rows, int n_atoms, int offset,
                  int stride, int count, int n_bonds, int n_angles, int b0,
                  int a0, int pbc, double* partials, float* energy,
                  void* stream) {
  const Template tp{offset, stride, count, n_bonds, n_angles,
                    n_atoms, b0, a0, pbc};
  if (!tp.valid()) return (int)cudaErrorInvalidValue;
  const Rows rw{bond_k, bond_r0, angle_k, angle_theta0, rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bonded_terms_fwd_kernel<<<tp.fwd_blocks(), kThreads, 0, s>>>(x, rw, box,
                                                                tp, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bonded_terms_total_kernel<<<1, kThreads, 0, s>>>(
      partials, static_cast<int>(tp.fwd_blocks()), energy);
  return (int)cudaGetLastError();
}

// The forward's inputs and ct [1] f32, the energy's cotangent (read on the
// device); writes ct dE/dx to g_x [n_atoms, 3] f32, zero outside the
// template's atoms.
int cf_bonded_bwd(const float* x, const float* bond_k, const float* bond_r0,
                  const float* angle_k, const float* angle_theta0,
                  const float* box, const int* rows, int n_atoms, int offset,
                  int stride, int count, int n_bonds, int n_angles, int b0,
                  int a0, int pbc, const float* ct, float* g_x,
                  void* stream) {
  const Template tp{offset, stride, count, n_bonds, n_angles,
                    n_atoms, b0, a0, pbc};
  if (!tp.valid()) return (int)cudaErrorInvalidValue;
  const Rows rw{bond_k, bond_r0, angle_k, angle_theta0, rows};
  bonded_terms_bwd_kernel<<<tp.bwd_blocks(), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, rw, box, tp, ct, g_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
