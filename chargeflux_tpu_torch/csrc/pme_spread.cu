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
//
// What bounds it on the H100.  Only `order` of the Gz z weights of a row are
// nonzero, so the useful work is n_col*Wx*Wyp*rows*order multiply-adds
// (173 M at the 30k main path: 64 columns, Wx 20, Wyp 24, rows 704, order
// 8) — tens of microseconds of FMA issue once the zeros are skipped — and
// the mesh (1.5 MB) and the weights (~6 MB) sit in the 50 MB L2.  Neither
// bound binds: both passes of the forward and the backward are limited by
// the latency of their serial per-row / per-tap loops (dependent loads and
// shared read-modify-writes), with few warps per block.
//
// Design.  The TPU grid ran in order and accumulated overlapping column
// patches into one VMEM-resident mesh; CUDA blocks run in parallel, and
// the JAX engine is bitwise reproducible, so there are no float atomics:
//   pass 1 (spread_patch_kernel): one block per (x, column) builds that
//     x-row of the column's patch, P[y, gz], in shared memory and writes it
//     to a scratch [n_col, Wx, Wyp, Gz].  The dense Wz is never built:
//     lane k of a group of `order` lanes adds the k-th tap at
//     (zorg + k) mod Gz.  A group's lanes share one y, groups are whole
//     within a warp (order divides 32), so one __syncwarp per row orders
//     the shared read-modify-writes and no block barrier is needed.
//   pass 2 (spread_fold_kernel): one thread per Qpad point sums, in column
//     order, the (at most 3x3 at the main path) patches that cover it.
// The backward is one thread per (column, row): it reads the <= Wx*Wyp*order
// mesh cotangents its taps touch and forms all three weight cotangents
// locally, so no reduction crosses threads.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWy = 32;     // Wyp bound of the backward's register arrays
constexpr int kMaxOrder = 16;  // spline-order bound of the same

__global__ void spread_patch_kernel(const float* __restrict__ qwlxt,
                                    const float* __restrict__ wlyt,
                                    const float* __restrict__ wzt,
                                    const int* __restrict__ zorg,
                                    float* __restrict__ scratch,
                                    int wx, int wyp, int order, int rows,
                                    int gz) {
  extern __shared__ float patch[];          // [Wyp, Gz]
  const int x = blockIdx.x;
  const int c = blockIdx.y;
  const int n_thr = blockDim.x;
  for (int i = threadIdx.x; i < wyp * gz; i += n_thr) patch[i] = 0.0f;
  __syncthreads();

  const int k = threadIdx.x % order;        // tap handled by this lane
  const int y = threadIdx.x / order;        // patch y row of this lane
  const bool active = y < wyp;
  const float* qx = qwlxt + ((size_t)c * wx + x) * rows;
  const float* wy = wlyt + ((size_t)c * wyp + (active ? y : 0)) * rows;
  const float* wz = wzt + ((size_t)c * order + k) * rows;
  const int* zo = zorg + (size_t)c * rows;
  float* prow = patch + (active ? y : 0) * gz;
  for (int r = 0; r < rows; ++r) {
    if (active) {
      int g = zo[r] + k;
      if (g >= gz) g -= gz;
      prow[g] += (qx[r] * wy[r]) * wz[r];
    }
    __syncwarp();
  }
  __syncthreads();
  float* out = scratch + ((size_t)c * wx + x) * wyp * gz;
  for (int i = threadIdx.x; i < wyp * gz; i += n_thr) out[i] = patch[i];
}

__global__ void spread_fold_kernel(const float* __restrict__ scratch,
                                   const int* __restrict__ offsets,
                                   float* __restrict__ qpad, int n_col,
                                   int wx, int wyp, int px, int py, int gz) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= px * py * gz) return;
  const int g = idx % gz;
  const int yy = (idx / gz) % py;
  const int xx = idx / (gz * py);
  float acc = 0.0f;
  for (int c = 0; c < n_col; ++c) {
    const int lx = xx - offsets[c];
    const int ly = yy - offsets[n_col + c];
    if (lx >= 0 && lx < wx && ly >= 0 && ly < wyp)
      acc += scratch[(((size_t)c * wx + lx) * wyp + ly) * gz + g];
  }
  qpad[idx] = acc;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups_per_warp = 32 / order;
  const int warps = (wyp + groups_per_warp - 1) / groups_per_warp;
  const size_t smem = sizeof(float) * (size_t)wyp * gz;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        spread_patch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  spread_patch_kernel<<<dim3(wx, n_col), warps * 32, smem, s>>>(
      qwlxt, wlyt, wzt, zorg, scratch, wx, wyp, order, rows, gz);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = px * py * gz;
  spread_fold_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      scratch, offsets, qpad, n_col, wx, wyp, px, py, gz);
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
