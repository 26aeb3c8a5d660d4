// The excluded pairs' energy correction of one molecule template for
// sm_90a, forward and backward.  A template is `count` copies of a
// `stride`-atom molecule on atoms [offset, offset + count * stride), each
// with the same local excluded pairs (rows [n_rows, 2], local indices); per
// pair (a, b), with the minimum-image displacement d = b - a in the box
// [3], r2 = |d|^2, inv_r = rsqrt(r2), r = r2 inv_r and erfc(alpha r) by
// Abramowitz & Stegun 7.1.26 (times exp(-x^2)):
//   e = -k q_a q_b inv_r (1 - erfc)
//       - [r < cutoff] (k q_a q_b inv_r erfc + LJ)  (with subtract_direct),
// LJ = eps s6 (s6 - 1), s6 = (hs inv_r)^6, hs = (sig_a + sig_b) / 2,
// eps = 4 sqrt(eps_a eps_b): the arithmetic of the plain chain in
// ops/exclusion.py (pair_terms with template=True), in its order.  The
// forward writes E = sum of e; the backward writes ct dE/dx [N, 3] and
// ct dE/dq [N] (zero outside the template's atoms), the analytic
// derivative of the same e, so forces stay the exact gradient of the
// computed energy.  No sigma, epsilon or box cotangent: nothing
// differentiates through them on this route (npt._box_grad_potential's box
// requires grad and takes the plain chain).
//
// Replaces no Pallas kernel.  The JAX package evaluates the same rows as
// jnp slices (energy._template_exclusion_correction), which XLA fuses into
// a loop; eager PyTorch ran each as its own op, some 410 graph nodes a
// forward plus backward (~0.62 ms of a 2.7 ms MD step at 98k atoms, each
// node ~1.5 us over 32,768 elements).
//
// What bounds it on the H100: nothing but latency.  At 98,304 atoms the
// forward reads 6 words an atom (2.4 MB, 0.7 us at 3.35 TB/s) for ~67
// flops a pair (6.6 MFLOP, 0.1 us of the f32 rate); the backward reads
// the same and writes 4 words an atom (3.9 MB, 1.2 us).  So each pass is
// one launch over the atoms that reads every word once into registers (the
// forward adds a one-block launch for its final sum):
//  * forward: one thread per molecule evaluates its rows in the rows'
//    order; the block sums its threads' energies in a fixed tree in f64
//    into one partial per block, and a one-block pass sums the partials in
//    a fixed order (no float atomics: two launches give the same bits);
//  * backward: one thread per atom recomputes the rows that hold it and
//    writes its own gradient once: a template's molecules own disjoint
//    atoms, so nothing is scattered;
//  * nothing is masked by a select that could swallow a NaN: a NaN
//    position or charge gives a NaN energy and NaN gradients, as the plain
//    chain does.
//
// Prediction, written before the kernels' first timed run: ~3-6 us each at
// 98k atoms (latency bound), in place of ~0.62 ms per MD step on an NVIDIA
// H100 80GB HBM3 at 700 W.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Abramowitz & Stegun 7.1.26 (ops/erfc.py's erfc_fast in f32)
constexpr float kP = 0.3275911f;
constexpr float kA1 = 0.254829592f;
constexpr float kA2 = -0.284496736f;
constexpr float kA3 = 1.421413741f;
constexpr float kA4 = -1.453152027f;
constexpr float kA5 = 1.061405429f;

struct Params {
  float alpha, cutoff, k;
  int subtract;
};

// The minimum-image displacement b - a (pairs.delta_periodic on a [3] box:
// d - box * floor(d / box + 0.5), the product rounded on its own as the
// plain chain's is).
__device__ __forceinline__ void displacement(const float* __restrict__ x,
                                             long long a, long long b,
                                             const float (&box)[3],
                                             float (&d)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = x[3 * b + c] - x[3 * a + c];
    d[c] = v - __fmul_rn(box[c], floorf(v / box[c] + 0.5f));
  }
}

// The pair's energy and, with GRAD, dE/dr2 and dE/d(q_a q_b).
template <bool GRAD>
__device__ __forceinline__ float pair_energy(float r2, float qq, float hs,
                                             float eps, const Params& p,
                                             float* de_dr2, float* de_dqq) {
  const float inv_r = rsqrtf(r2);
  const float r = r2 * inv_r;
  const float x = p.alpha * r;
  const float t = 1.f / (1.f + kP * x);
  const float poly = t * (kA1 + t * (kA2 + t * (kA3 + t * (kA4 + t * kA5))));
  const float ex = expf(-x * x);
  const float erfc = poly * ex;
  const float kqq = p.k * qq;
  float e = (-kqq * inv_r) * (1.f - erfc);
  // r < cutoff is false for a NaN r, whose first term is NaN already
  const bool in_cut = p.subtract && r < p.cutoff;
  const float hr = hs * inv_r;
  const float s2 = hr * hr;
  const float s6 = s2 * s2 * s2;
  if (in_cut) e = e - ((kqq * inv_r) * erfc + (eps * s6) * (s6 - 1.f));
  if (GRAD) {
    // partial derivatives in inv_r, erfc and qq, each term as autograd
    // meets it (the erfc terms cancel inside the cutoff: a - a, NaN kept)
    float d_inv = -kqq * (1.f - erfc);
    float d_erfc = kqq * inv_r;
    float d_qq = -p.k * inv_r * (1.f - erfc);
    if (in_cut) {
      const float d_s6 = eps * (2.f * s6 - 1.f);
      d_inv = d_inv - (kqq * erfc + d_s6 * (3.f * s2 * s2) * (2.f * hr * hs));
      d_erfc = d_erfc - kqq * inv_r;
      d_qq = d_qq - p.k * inv_r * erfc;
    }
    const float d_poly =
        kA1 + t * (2.f * kA2 + t * (3.f * kA3 + t * (4.f * kA4 +
                                                     t * (5.f * kA5))));
    const float d_erfc_dx = ex * (d_poly * (-kP * t * t) - 2.f * x * poly);
    // inv_r = r2^-1/2, r = r2 inv_r: d inv_r / d r2 = -inv_r^3 / 2 and
    // dr / dr2 = inv_r / 2
    *de_dr2 = d_inv * (-0.5f * inv_r * inv_r * inv_r) +
              d_erfc * d_erfc_dx * p.alpha * (0.5f * inv_r);
    *de_dqq = d_qq;
  }
  return e;
}

struct Template {
  int offset, stride, count, n_rows, n_atoms;

  bool valid() const {
    return offset >= 0 && stride >= 2 && count >= 1 && n_rows >= 1 &&
           static_cast<long long>(offset) +
                   static_cast<long long>(count) * stride <=
               n_atoms;
  }
  unsigned fwd_blocks() const {
    return static_cast<unsigned>((count + kThreads - 1) / kThreads);
  }
  unsigned bwd_blocks() const {
    return static_cast<unsigned>((n_atoms + kThreads - 1) / kThreads);
  }
};

__global__ void __launch_bounds__(kThreads)
exclusion_pairs_fwd_kernel(const float* __restrict__ x,
                           const float* __restrict__ q,
                           const float* __restrict__ sig,
                           const float* __restrict__ eps,
                           const float* __restrict__ box,
                           const int* __restrict__ rows, Template tp,
                           Params p, double* __restrict__ partials) {
  __shared__ double red[kThreads];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  double acc = 0.0;
  if (m < tp.count) {
    const float bx[3] = {box[0], box[1], box[2]};
    const long long base =
        tp.offset + static_cast<long long>(m) * tp.stride;
    for (int r = 0; r < tp.n_rows; ++r) {
      const long long a = base + rows[2 * r], b = base + rows[2 * r + 1];
      float d[3];
      displacement(x, a, b, bx, d);
      const float r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      acc += static_cast<double>(pair_energy<false>(
          r2, q[a] * q[b], 0.5f * (sig[a] + sig[b]),
          4.f * sqrtf(eps[a] * eps[b]), p, nullptr, nullptr));
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
exclusion_pairs_total_kernel(const double* __restrict__ partials, int n,
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
exclusion_pairs_bwd_kernel(const float* __restrict__ x,
                           const float* __restrict__ q,
                           const float* __restrict__ sig,
                           const float* __restrict__ eps,
                           const float* __restrict__ box,
                           const int* __restrict__ rows, Template tp,
                           Params p, const float* __restrict__ ct,
                           float* __restrict__ g_x, float* __restrict__ g_q) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= tp.n_atoms) return;
  float g[3] = {0.f, 0.f, 0.f};
  float gq = 0.f;
  const long long local = i - tp.offset;
  if (local >= 0 && local < static_cast<long long>(tp.count) * tp.stride) {
    const long long m = local / tp.stride;
    const int l = static_cast<int>(local - m * tp.stride);
    const long long base = tp.offset + m * tp.stride;
    const float bx[3] = {box[0], box[1], box[2]};
    for (int r = 0; r < tp.n_rows; ++r) {
      const int l1 = rows[2 * r], l2 = rows[2 * r + 1];
      if (l1 != l && l2 != l) continue;
      const long long a = base + l1, b = base + l2;
      float d[3];
      displacement(x, a, b, bx, d);
      const float r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      float de_dr2, de_dqq;
      pair_energy<true>(r2, q[a] * q[b], 0.5f * (sig[a] + sig[b]),
                        4.f * sqrtf(eps[a] * eps[b]), p, &de_dr2, &de_dqq);
      // d = x_b - x_a: +dE/dd on b, -dE/dd on a
      const float s = l == l2 ? 2.f * de_dr2 : -2.f * de_dr2;
#pragma unroll
      for (int c = 0; c < 3; ++c) g[c] += s * d[c];
      gq += de_dqq * (l == l1 ? q[b] : q[a]);
    }
    const float c = *ct;
#pragma unroll
    for (int k = 0; k < 3; ++k) g[k] = c * g[k];
    gq = c * gq;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) g_x[3 * i + k] = g[k];
  g_q[i] = gq;
}

}  // namespace

extern "C" {

// The threads per block of the forward, so its partials number
// ceil(count / threads).
int cf_exclusion_limits(int* threads) {
  *threads = kThreads;
  return 0;
}

// x [n_atoms, 3], q, sig, eps [n_atoms] f32, box [3] f32, rows [n_rows, 2]
// int32 local pair indices; partials [ceil(count / threads)] f64 scratch;
// writes E to energy [1] f32.
int cf_exclusion_fwd(const float* x, const float* q, const float* sig,
                     const float* eps, const float* box, const int* rows,
                     int n_atoms, int offset, int stride, int count,
                     int n_rows, float alpha, float cutoff, float k,
                     int subtract, double* partials, float* energy,
                     void* stream) {
  const Template tp{offset, stride, count, n_rows, n_atoms};
  if (!tp.valid()) return (int)cudaErrorInvalidValue;
  const Params p{alpha, cutoff, k, subtract};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  exclusion_pairs_fwd_kernel<<<tp.fwd_blocks(), kThreads, 0, s>>>(
      x, q, sig, eps, box, rows, tp, p, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exclusion_pairs_total_kernel<<<1, kThreads, 0, s>>>(
      partials, static_cast<int>(tp.fwd_blocks()), energy);
  return (int)cudaGetLastError();
}

// The forward's inputs and ct [1] f32, the energy's cotangent (read on the
// device); writes ct dE/dx to g_x [n_atoms, 3] and ct dE/dq to g_q
// [n_atoms] f32, zero outside the template's atoms.
int cf_exclusion_bwd(const float* x, const float* q, const float* sig,
                     const float* eps, const float* box, const int* rows,
                     int n_atoms, int offset, int stride, int count,
                     int n_rows, float alpha, float cutoff, float k,
                     int subtract, const float* ct, float* g_x, float* g_q,
                     void* stream) {
  const Template tp{offset, stride, count, n_rows, n_atoms};
  if (!tp.valid()) return (int)cudaErrorInvalidValue;
  const Params p{alpha, cutoff, k, subtract};
  exclusion_pairs_bwd_kernel<<<tp.bwd_blocks(), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, q, sig, eps, box, rows, tp, p, ct, g_x, g_q);
  return (int)cudaGetLastError();
}

}  // extern "C"
