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
//
// What bounds it on the H100.  Each of the three contractions is
// 2 * Kx*Ky * N * 2Kz multiply-adds: 3.1 M at the 216-water path (Kx 7,
// Ky 13, 2Kz 26, N 648), 130 M at a 4k box with kmax 13^3 (Kx 13, Ky 25,
// 2Kz 50, N 3993) — 0.1 and 4 us of the card's f32 FMA issue rate.  The
// inputs are < 1.5 MB and the forward's chunk partials 8 MB at 4k, all in
// the 50 MB L2.  Neither bound binds at these sizes: the kernels are
// limited by the latency of their serial inner loops over shared memory
// and, at 216, by having few blocks (11 to 77) for 132 SMs.
//
// Design.  The TPU grid ran its atom tiles in order and accumulated A and B
// in VMEM; CUDA blocks run in parallel, and the engine stays bitwise
// reproducible, so there are no float atomics and every output has one
// writer:
//   forward: one block per (kx, chunk of kChunk atoms) forms the chunk's
//     cxy/sxy rows for that kx in shared memory once, stages the chunk's zq
//     rows, and each thread owns (ky, c) outputs of A and B over the chunk;
//     the per-chunk partials [2, chunks, Kx*Ky, 2Kz] are then summed in
//     chunk order by sf_sum_kernel (one thread per output).
//   backward: atom-parallel, one thread per atom.  Abar/Bbar stream through
//     shared memory one kx slab [Ky, 2Kz] at a time; the thread's zq row,
//     cy/sy columns and its dcy/dsy (tables) or dzq (zq) accumulators live
//     in thread-private shared columns, so nothing is reduced across
//     threads.  No tensor cores: the TPU kernel ran at Precision.HIGHEST,
//     and TF32 would cost the f32 force budget.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxKy = 64;      // Ky = 2 kmax_y - 1 bound (kmax_y <= 32)
constexpr int kMaxKz2 = 128;    // 2Kz = 2 (2 kmax_z - 1) bound (kmax_z <= 32)
constexpr int kChunk = 64;      // atoms per forward block
constexpr int kFwdThreads = 256;
constexpr int kBwdAtoms = 64;   // atoms (threads) per backward block
constexpr int kLd = kBwdAtoms + 1;  // padded stride of [2Kz][atoms] columns

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

__global__ void sf_bwd_tables_kernel(
    const float* __restrict__ cxT, const float* __restrict__ sxT,
    const float* __restrict__ cyT, const float* __restrict__ syT,
    const float* __restrict__ zq, const float* __restrict__ abar,
    const float* __restrict__ bbar, float* __restrict__ dcx,
    float* __restrict__ dsx, float* __restrict__ dcy,
    float* __restrict__ dsy, int kx, int ky, int kz2, int n) {
  extern __shared__ float smem[];
  constexpr int T = kBwdAtoms;
  float* as = smem;                  // [ky][kz2] Abar rows of one kx
  float* bs = as + ky * kz2;         // [ky][kz2] Bbar rows of one kx
  float* zs = bs + ky * kz2;         // [kz2][kLd] zq of the block's atoms
  float* cys = zs + kz2 * kLd;       // [ky][T]
  float* sys = cys + ky * T;         // [ky][T]
  float* dcys = sys + ky * T;        // [ky][T] dcy accumulators
  float* dsys = dcys + ky * T;       // [ky][T] dsy accumulators
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * T;
  const int cnt = min(T, n - n0);
  const bool live = t < cnt;
  const size_t a = (size_t)n0 + t;

  // the block's zq rows are one contiguous span: coalesced reads
  for (int i = t; i < T * kz2; i += T) {
    const int j = i / kz2;
    const int c = i % kz2;
    zs[c * kLd + j] = j < cnt ? zq[(size_t)n0 * kz2 + i] : 0.0f;
  }
  for (int y = 0; y < ky; ++y) {
    cys[y * T + t] = live ? cyT[(size_t)y * n + a] : 0.0f;
    sys[y * T + t] = live ? syT[(size_t)y * n + a] : 0.0f;
    dcys[y * T + t] = 0.0f;
    dsys[y * T + t] = 0.0f;
  }
  for (int x = 0; x < kx; ++x) {
    __syncthreads();  // the previous slab is consumed; zs is visible
    const size_t slab = (size_t)x * ky * kz2;
    for (int i = t; i < ky * kz2; i += T) {
      as[i] = abar[slab + i];
      bs[i] = bbar[slab + i];
    }
    __syncthreads();
    const float cx = live ? cxT[(size_t)x * n + a] : 0.0f;
    const float sx = live ? sxT[(size_t)x * n + a] : 0.0f;
    float dcx_acc = 0.0f, dsx_acc = 0.0f;
    for (int y = 0; y < ky; ++y) {
      const float* ar = as + y * kz2;
      const float* br = bs + y * kz2;
      float gc = 0.0f, gs = 0.0f;
      for (int c = 0; c < kz2; ++c) {
        const float z = zs[c * kLd + t];
        gc = fmaf(ar[c], z, gc);
        gs = fmaf(br[c], z, gs);
      }
      const float cy = cys[y * T + t], sy = sys[y * T + t];
      dcx_acc += gc * cy + gs * sy;
      dsx_acc += gs * cy - gc * sy;
      dcys[y * T + t] += gc * cx + gs * sx;
      dsys[y * T + t] += gs * cx - gc * sx;
    }
    if (live) {
      dcx[(size_t)x * n + a] = dcx_acc;
      dsx[(size_t)x * n + a] = dsx_acc;
    }
  }
  if (live) {
    for (int y = 0; y < ky; ++y) {
      dcy[(size_t)y * n + a] = dcys[y * T + t];
      dsy[(size_t)y * n + a] = dsys[y * T + t];
    }
  }
}

__global__ void sf_bwd_zq_kernel(
    const float* __restrict__ cxT, const float* __restrict__ sxT,
    const float* __restrict__ cyT, const float* __restrict__ syT,
    const float* __restrict__ abar, const float* __restrict__ bbar,
    float* __restrict__ dzq, int kx, int ky, int kz2, int n) {
  extern __shared__ float smem[];
  constexpr int T = kBwdAtoms;
  float* as = smem;                  // [ky][kz2] Abar rows of one kx
  float* bs = as + ky * kz2;         // [ky][kz2] Bbar rows of one kx
  float* cys = bs + ky * kz2;        // [ky][T]
  float* sys = cys + ky * T;         // [ky][T]
  float* cxys = sys + ky * T;        // [ky][T] cxy of the current kx
  float* sxys = cxys + ky * T;       // [ky][T] sxy of the current kx
  float* dzs = sxys + ky * T;        // [kz2][kLd] dzq accumulators
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * T;
  const int cnt = min(T, n - n0);
  const bool live = t < cnt;
  const size_t a = (size_t)n0 + t;

  for (int y = 0; y < ky; ++y) {
    cys[y * T + t] = live ? cyT[(size_t)y * n + a] : 0.0f;
    sys[y * T + t] = live ? syT[(size_t)y * n + a] : 0.0f;
  }
  for (int c = 0; c < kz2; ++c) dzs[c * kLd + t] = 0.0f;
  for (int x = 0; x < kx; ++x) {
    __syncthreads();  // the previous slab is consumed
    const size_t slab = (size_t)x * ky * kz2;
    for (int i = t; i < ky * kz2; i += T) {
      as[i] = abar[slab + i];
      bs[i] = bbar[slab + i];
    }
    const float cx = live ? cxT[(size_t)x * n + a] : 0.0f;
    const float sx = live ? sxT[(size_t)x * n + a] : 0.0f;
    for (int y = 0; y < ky; ++y) {
      const float cy = cys[y * T + t], sy = sys[y * T + t];
      cxys[y * T + t] = cx * cy - sx * sy;
      sxys[y * T + t] = sx * cy + cx * sy;
    }
    __syncthreads();
    for (int c = 0; c < kz2; ++c) {
      float acc = 0.0f;
      for (int y = 0; y < ky; ++y) {
        acc = fmaf(cxys[y * T + t], as[y * kz2 + c], acc);
        acc = fmaf(sxys[y * T + t], bs[y * kz2 + c], acc);
      }
      dzs[c * kLd + t] += acc;
    }
  }
  __syncthreads();
  // the block's dzq rows are one contiguous span: coalesced writes
  for (int i = t; i < cnt * kz2; i += T)
    dzq[(size_t)n0 * kz2 + i] = dzs[(i % kz2) * kLd + i / kz2];
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
  const size_t smem = sizeof(float) * ((size_t)2 * ky * kz2 +
                                       (size_t)kz2 * kLd +
                                       (size_t)4 * ky * kBwdAtoms);
  cudaError_t e = allow_smem(sf_bwd_tables_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sf_bwd_tables_kernel<<<(n + kBwdAtoms - 1) / kBwdAtoms, kBwdAtoms, smem,
                         s>>>(cxT, sxT, cyT, syT, zq, abar, bbar, dcx, dsx,
                              dcy, dsy, kx, ky, kz2, n);
  return (int)cudaGetLastError();
}

// Backward, zq: dzq [n, kz2] is the output.
int cf_sf_bwd_zq(const float* cxT, const float* sxT, const float* cyT,
                 const float* syT, const float* abar, const float* bbar,
                 float* dzq, int kx, int ky, int kz2, int n, void* stream) {
  if (bad_shape(kx, ky, kz2, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)2 * ky * kz2 +
                                       (size_t)4 * ky * kBwdAtoms +
                                       (size_t)kz2 * kLd);
  cudaError_t e = allow_smem(sf_bwd_zq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sf_bwd_zq_kernel<<<(n + kBwdAtoms - 1) / kBwdAtoms, kBwdAtoms, smem, s>>>(
      cxT, sxT, cyT, syT, abar, bbar, dzq, kx, ky, kz2, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
