// B-spline patch weights of the cell route's SPME spread for sm_90a, forward
// and backward.  Given the cell blocks' coordinates x, y, z, charges q and
// atom ids ([ngx, ngy, ngz, cap], one slot each) and the axis lengths L
// (the box, or ones for a lattice's fractional coordinates), with
// u = coord * (G / L) per axis, the forward writes in the layout that
// ops/pme_spread's kernels read (column c = cx * ngy + cy, row
// r = cz * cap + a):
//   qwlxt [n_col, Wx, rows]   q M_p(u_x - (ox[cx] + j)), q zeroed where
//                             ids >= n_atoms;
//   wlyt  [n_col, Wyp, rows]  M_p(u_y - (oy[cy] + j)) for j < Wy, 0 above;
//   wzt   [n_col, p, rows]    M_p(u_z - o_z - k), o_z = floor(u_z) - (p - 1);
//   zorg  [n_col, 1, rows]    o_z mod Gz (int32);
// with the cell patch origins ox, oy of pme._patch_origins.  The backward
// takes the cotangents of qwlxt, wlyt and wzt and writes dE/dx, dE/dy,
// dE/dz (times G / L) and dE/dq, from M_p' = M_{p-1}(t) - M_{p-1}(t - 1).
// No box cotangent: the one potential differentiated through the box
// (npt._box_grad_potential) takes the classical reciprocal, not this route;
// a lattice's fractional coordinates take theirs back through autograd.
//
// Replaces no Pallas kernel.  The JAX package computes the same weights as
// plain jnp (pme._cell_patch_weights and bspline inside
// pme_cell_pallas_reciprocal_energy), which XLA fuses into one loop; eager
// PyTorch ran them as some 500 elementwise launches per evaluation, each
// over a 10 MB tap array [ngx, ngy, W, ngz, cap] (~10.8 GB of operand
// traffic a force evaluation at 98k atoms, 74 % of the MD step).
//
// What bounds it on the H100.  Bytes: at 98k atoms (8^3 cells of 256 slots,
// Wx 20, Wyp 24, p 8) the forward reads 5 words and writes 53 per slot,
// 30 MB, 9 us at 3.35 TB/s; its flops (three order-8 recursions, ~500 a
// slot) are ~1 us of the f32 rate.  The backward reads the 3p in-support
// cotangents and writes 4 words per slot.  So the design moves each word
// once and keeps every intermediate in registers:
//  * one thread per slot, the row index fastest, so that every store of a
//    tap row (and every load of a cotangent row) is coalesced along rows;
//  * de Boor's recursion on the p support points of each axis
//    M_n(w + k) = [(w + k) M_{n-1}(w + k) + (n - w - k) M_{n-1}(w + k - 1)]
//    / (n - 1), O(p^2) flops for all p taps at once (the plain chain
//    evaluates the recursion at every one of the W taps), with the
//    arguments w + k formed as the plain chain forms its t = u - (o + j);
//  * taps outside the support are stored as exact zeros (the plain
//    clamp's), a non-finite u writes NaN to every tap of its axis and reads
//    back NaN, as the plain chain does (energies are NaN-poisoned, never
//    silently wrong);
//  * the backward reads only the p in-support cotangents of each axis;
//  * the spline order is a template argument (4 to 8), so the tables stay
//    in registers; the patch widths are runtime values.
//
// Prediction, written before the kernels' first timed run (98k: 131,072
// slots): forward 12-30 us, backward 8-25 us, in place of ~5.8 ms of the
// reciprocal's 6.2 ms per MD step on an NVIDIA H100 80GB HBM3 at 700 W.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinOrder = 4;
constexpr int kMaxOrder = 8;

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fffffff);
}

// The order-N values m[k] = M_N(a[k]) on the support points of one atom,
// a[k] = w + k (k < P; M_N vanishes at k >= N), built up from M_2.
template <int P, int N>
__device__ __forceinline__ void spline_table(const float (&a)[P],
                                             float (&m)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k)
    m[k] = k < 2 ? fmaxf(1.f - fabsf(a[k] - 1.f), 0.f) : 0.f;
#pragma unroll
  for (int n = 3; n <= N; ++n) {
#pragma unroll
    for (int k = n - 1; k >= 0; --k) {    // m[k - 1] is still order n - 1
      const float lo = k > 0 ? m[k - 1] : 0.f;
      m[k] = (a[k] * m[k] + (static_cast<float>(n) - a[k]) * lo) /
             static_cast<float>(n - 1);
    }
  }
}

// One axis of one slot: u, its floor f and the support arguments
// a[k] = u - (f - k) (the plain chain's t of the tap at f - k), and b, the
// patch index of the tap whose argument is w = a[0] relative to the patch
// origin `org` (-1 when u is not finite or lies far outside the patch, so
// that no tap j = b - k is in [0, w)).
template <int P>
struct Axis {
  float a[P];
  float f;
  int b;
  bool finite;

  __device__ __forceinline__ Axis(float u, int org, int w) {
    f = floorf(u);
    finite = fabsf(u) < __int_as_float(0x7f800000);    // not inf, not NaN
#pragma unroll
    for (int k = 0; k < P; ++k) a[k] = u - (f - static_cast<float>(k));
    const float bf = f - static_cast<float>(org);
    b = finite && bf >= 0.f && bf < static_cast<float>(w + P)
            ? static_cast<int>(bf)
            : -1;
  }
};

// M_P at the support points from the order P - 1 table m1.
template <int P>
__device__ __forceinline__ float spline_up(const float (&a)[P],
                                           const float (&m1)[P], int k) {
  const float lo = k > 0 ? m1[k - 1] : 0.f;
  return (a[k] * m1[k] + (static_cast<float>(P) - a[k]) * lo) /
         static_cast<float>(P - 1);
}

// Writes a patch row block: out[j * stride] = mult * M_P(u - (org + j)) for
// j < w_taps, exact zeros for w_taps <= j < w_rows.
template <int P>
__device__ __forceinline__ void write_patch(float u, int org, int w_taps,
                                            int w_rows, float mult,
                                            float* __restrict__ out,
                                            long long stride) {
  const Axis<P> ax(u, org, w_taps);
  float m[P];
  spline_table<P, P>(ax.a, m);
  for (int j = 0; j < w_rows; ++j) {
    float v = 0.f;
    if (j < w_taps) {
      if (!ax.finite) {
        v = quiet_nan();
      } else {
        const int k = ax.b - j;
#pragma unroll
        for (int kk = 0; kk < P; ++kk) v = k == kk ? m[kk] : v;
      }
      v = mult * v;
    }
    out[j * stride] = v;
  }
}

// The slot's column and row, its charge with the sentinel slots' zeroed,
// and the three scales G / L (formed as the plain chain forms them,
// reciprocal first).
struct Slot {
  int c, r, cx, cy;
  bool real;
  float qv;
  float sx, sy, sz;

  __device__ __forceinline__ Slot(long long s, int rows, int ngy,
                                  const float* __restrict__ q,
                                  const int* __restrict__ ids, int n_atoms,
                                  const float* __restrict__ lengths, int gx,
                                  int gy, int gz) {
    c = static_cast<int>(s / rows);
    r = static_cast<int>(s - static_cast<long long>(c) * rows);
    cx = c / ngy;
    cy = c - cx * ngy;
    real = ids[s] < n_atoms;
    qv = real ? q[s] : 0.f;
    sx = (1.f / lengths[0]) * static_cast<float>(gx);
    sy = (1.f / lengths[1]) * static_cast<float>(gy);
    sz = (1.f / lengths[2]) * static_cast<float>(gz);
  }
};

template <int P>
__global__ void __launch_bounds__(kThreads)
bspline_patch_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         const float* __restrict__ z,
                         const float* __restrict__ q,
                         const int* __restrict__ ids,
                         const float* __restrict__ lengths,
                         const int* __restrict__ orgx,
                         const int* __restrict__ orgy, int n_atoms, int ngy,
                         int rows, int gx, int gy, int gz, int wx, int wy,
                         int wyp, long long n_slots,
                         float* __restrict__ qwlxt, float* __restrict__ wlyt,
                         float* __restrict__ wzt, int* __restrict__ zorg) {
  const long long s = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (s >= n_slots) return;
  const Slot sl(s, rows, ngy, q, ids, n_atoms, lengths, gx, gy, gz);
  const long long c = sl.c;
  write_patch<P>(x[s] * sl.sx, orgx[sl.cx], wx, wx, sl.qv,
                 qwlxt + c * wx * rows + sl.r, rows);
  write_patch<P>(y[s] * sl.sy, orgy[sl.cy], wy, wyp, 1.f,
                 wlyt + c * wyp * rows + sl.r, rows);

  // z: the p compact taps k at o_z + k, o_z = floor(u) - (p - 1), so tap k
  // has the support argument w + p - 1 - k
  const float u = z[s] * sl.sz;
  const Axis<P> ax(u, 0, 0);
  float m[P];
  spline_table<P, P>(ax.a, m);
  float* wz = wzt + c * P * rows + sl.r;
#pragma unroll
  for (int k = 0; k < P; ++k)
    wz[k * static_cast<long long>(rows)] =
        ax.finite ? m[P - 1 - k] : quiet_nan();
  int zo = 0;
  if (ax.finite) {
    // torch.remainder's float form: fmod, moved to the divisor's sign
    const float g = static_cast<float>(gz);
    float md = fmodf(ax.f - static_cast<float>(P - 1), g);
    if (md != 0.f && md < 0.f) md += g;
    zo = static_cast<int>(md);
  }
  zorg[c * rows + sl.r] = zo;
}

// Sum over the in-support taps of one axis of d[j] * M_P'(t_j) (slope) and,
// with VALUE, of d[j] * M_P(t_j); `mult` scales each cotangent first (the
// charge, for qwlxt), as autograd through q * w does.
template <int P, bool VALUE>
__device__ __forceinline__ void patch_cotangent(float u, int org, int w,
                                                float mult,
                                                const float* __restrict__ d,
                                                long long stride,
                                                float* slope, float* value) {
  const Axis<P> ax(u, org, w);
  float m1[P];
  spline_table<P, P - 1>(ax.a, m1);
  float acc = 0.f, accv = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int j = ax.b - k;
    if (j >= 0 && j < w) {
      const float dj = d[j * stride];
      acc += (mult * dj) * (m1[k] - (k > 0 ? m1[k - 1] : 0.f));
      if (VALUE) accv += dj * spline_up<P>(ax.a, m1, k);
    }
  }
  *slope = ax.finite ? acc : quiet_nan();
  if (VALUE) *value = ax.finite ? accv : quiet_nan();
}

template <int P>
__global__ void __launch_bounds__(kThreads)
bspline_patch_bwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         const float* __restrict__ z,
                         const float* __restrict__ q,
                         const int* __restrict__ ids,
                         const float* __restrict__ lengths,
                         const int* __restrict__ orgx,
                         const int* __restrict__ orgy,
                         const float* __restrict__ d_qwlxt,
                         const float* __restrict__ d_wlyt,
                         const float* __restrict__ d_wzt, int n_atoms,
                         int ngy, int rows, int gx, int gy, int gz, int wx,
                         int wy, int wyp, long long n_slots,
                         float* __restrict__ g_x, float* __restrict__ g_y,
                         float* __restrict__ g_z, float* __restrict__ g_q) {
  const long long s = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (s >= n_slots) return;
  const Slot sl(s, rows, ngy, q, ids, n_atoms, lengths, gx, gy, gz);
  const long long c = sl.c;
  float du, dq;
  patch_cotangent<P, true>(x[s] * sl.sx, orgx[sl.cx], wx, sl.qv,
                           d_qwlxt + c * wx * rows + sl.r, rows, &du, &dq);
  g_x[s] = du * sl.sx;
  g_q[s] = sl.real ? dq : 0.f;
  patch_cotangent<P, false>(y[s] * sl.sy, orgy[sl.cy], wy, 1.f,
                            d_wlyt + c * wyp * rows + sl.r, rows, &du,
                            nullptr);
  g_y[s] = du * sl.sy;

  const float u = z[s] * sl.sz;
  const Axis<P> ax(u, 0, 0);
  float m1[P];
  spline_table<P, P - 1>(ax.a, m1);
  const float* dz = d_wzt + c * P * rows + sl.r;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int kk = P - 1 - k;             // tap k's support point
    acc += dz[k * static_cast<long long>(rows)] *
           (m1[kk] - (kk > 0 ? m1[kk - 1] : 0.f));
  }
  g_z[s] = (ax.finite ? acc : quiet_nan()) * sl.sz;
}

struct Dims {
  int n_atoms, ngx, ngy, ngz, cap, gx, gy, gz, order, wx, wy, wyp;

  bool valid() const {
    return n_atoms >= 0 && ngx >= 1 && ngy >= 1 && ngz >= 1 && cap >= 1 &&
           gx >= 1 && gy >= 1 && gz >= 1 && order >= kMinOrder &&
           order <= kMaxOrder && wx >= 1 && wy >= 1 && wyp >= wy;
  }
  long long slots() const {
    return static_cast<long long>(ngx) * ngy * ngz * cap;
  }
  unsigned blocks() const {
    return static_cast<unsigned>((slots() + kThreads - 1) / kThreads);
  }
};

template <int P>
cudaError_t launch_fwd(const Dims& d, const float* x, const float* y,
                       const float* z, const float* q, const int* ids,
                       const float* lengths, const int* orgx,
                       const int* orgy, float* qwlxt, float* wlyt, float* wzt,
                       int* zorg, cudaStream_t s) {
  bspline_patch_fwd_kernel<P><<<d.blocks(), kThreads, 0, s>>>(
      x, y, z, q, ids, lengths, orgx, orgy, d.n_atoms, d.ngy, d.ngz * d.cap,
      d.gx, d.gy, d.gz, d.wx, d.wy, d.wyp, d.slots(), qwlxt, wlyt, wzt,
      zorg);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_bwd(const Dims& d, const float* x, const float* y,
                       const float* z, const float* q, const int* ids,
                       const float* lengths, const int* orgx,
                       const int* orgy, const float* d_qwlxt,
                       const float* d_wlyt, const float* d_wzt, float* g_x,
                       float* g_y, float* g_z, float* g_q, cudaStream_t s) {
  bspline_patch_bwd_kernel<P><<<d.blocks(), kThreads, 0, s>>>(
      x, y, z, q, ids, lengths, orgx, orgy, d_qwlxt, d_wlyt, d_wzt,
      d.n_atoms, d.ngy, d.ngz * d.cap, d.gx, d.gy, d.gz, d.wx, d.wy, d.wyp,
      d.slots(), g_x, g_y, g_z, g_q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The spline orders the kernels are instantiated for, lowest and highest.
int cf_bspline_limits(int* min_order, int* max_order) {
  *min_order = kMinOrder;
  *max_order = kMaxOrder;
  return 0;
}

// x, y, z, q [ngx, ngy, ngz, cap] f32, ids the same int32, lengths [3] f32,
// orgx [ngx] and orgy [ngy] int32 patch origins; outputs qwlxt
// [ngx ngy, wx, ngz cap], wlyt [ngx ngy, wyp, ngz cap], wzt
// [ngx ngy, order, ngz cap] f32 and zorg [ngx ngy, 1, ngz cap] int32.
int cf_bspline_patch_fwd(const float* x, const float* y, const float* z,
                         const float* q, const int* ids, const float* lengths,
                         const int* orgx, const int* orgy, int n_atoms,
                         int ngx, int ngy, int ngz, int cap, int gx, int gy,
                         int gz, int order, int wx, int wy, int wyp,
                         float* qwlxt, float* wlyt, float* wzt, int* zorg,
                         void* stream) {
  const Dims d{n_atoms, ngx, ngy, ngz, cap, gx, gy, gz, order, wx, wy, wyp};
  if (!d.valid()) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (order) {
#define CF_FWD(P)                                                          \
  case P:                                                                  \
    return (int)launch_fwd<P>(d, x, y, z, q, ids, lengths, orgx, orgy,     \
                              qwlxt, wlyt, wzt, zorg, s);
    CF_FWD(4) CF_FWD(5) CF_FWD(6) CF_FWD(7) CF_FWD(8)
#undef CF_FWD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The forward's inputs, then the cotangents of qwlxt, wlyt and wzt in its
// output layouts; outputs dE/dx, dE/dy, dE/dz and dE/dq [ngx, ngy, ngz,
// cap] f32.
int cf_bspline_patch_bwd(const float* x, const float* y, const float* z,
                         const float* q, const int* ids, const float* lengths,
                         const int* orgx, const int* orgy,
                         const float* d_qwlxt, const float* d_wlyt,
                         const float* d_wzt, int n_atoms, int ngx, int ngy,
                         int ngz, int cap, int gx, int gy, int gz, int order,
                         int wx, int wy, int wyp, float* g_x, float* g_y,
                         float* g_z, float* g_q, void* stream) {
  const Dims d{n_atoms, ngx, ngy, ngz, cap, gx, gy, gz, order, wx, wy, wyp};
  if (!d.valid()) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (order) {
#define CF_BWD(P)                                                          \
  case P:                                                                  \
    return (int)launch_bwd<P>(d, x, y, z, q, ids, lengths, orgx, orgy,     \
                              d_qwlxt, d_wlyt, d_wzt, g_x, g_y, g_z, g_q,  \
                              s);
    CF_BWD(4) CF_BWD(5) CF_BWD(6) CF_BWD(7) CF_BWD(8)
#undef CF_BWD
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
