// Batched trust-region KL evaluation for Hopper (sm_90a): kernel B3.
//
// Replaces the TPU kernel gmmvi_tpu/ops/pallas_trust_region.py
// `_tr_kl_kernel`.  Python wrapper and plain version:
// gmmvi_tpu_torch/ops/trust_region.py.
//
// For every component k at its own eta_k: P = old_prec + R_quad / eta,
// l = old_lin + R_lin / eta, the Cholesky factor L of P, the new mean
// P^{-1} l and KL(new || old) = 0.5 (kl_const + log|P| + ||L^{-1} O^T||_F^2
// + ||O (mean_old - mean_new)||^2), with O the old inverse Cholesky factor.
// eta <= 0 or a non-positive pivot gives F32_MAX.
//
// What bounds it on this card: neither bytes nor FMAs.  At the main path's
// shape (K=48, D=20) one call reads ~0.13 MB (the lower triangles of the
// old precision, R_quad and O, and the vectors) and does ~0.6 MFLOP, a
// fraction of a microsecond of either; the call is as long as its launch
// and the D sequential elimination steps, each a pair of block barriers.
//
// Design: one block per component, the D x D matrix P and the right-hand
// side O^T in shared memory.  A right-looking Cholesky scales column j,
// then updates the trailing lower triangle with block-wide parallelism; the
// two forward solves the KL needs (L z = l for the mean, L Y = O^T for the
// trace term) ride along inside the same elimination, as on the TPU, so
// there is no separate solve pass.  The back-substitution L^T m = z is D^2
// FMAs on one thread, and the trace and Mahalanobis sums reduce in a fixed
// order.  The bisection around it stays in PyTorch, one launch per trip;
// fusing the whole search into one launch is later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;
constexpr float F32_MAX = 3.4028234663852886e38f;

__global__ void __launch_bounds__(NT)
tr_kl_kernel(const float* __restrict__ etas, const float* __restrict__ prec,
             const float* __restrict__ rq, const float* __restrict__ lin,
             const float* __restrict__ rlin, const float* __restrict__ oic,
             const float* __restrict__ means,
             const float* __restrict__ klconst, float* __restrict__ kl,
             int D) {
  extern __shared__ float sm[];
  const int dd = D * D;
  float* A = sm;         // [D, D]: P, its lower triangle becomes L
  float* R = A + dd;     // [D, D]: O^T, becomes Y = L^{-1} O^T
  float* y = R + dd;     // [D]: l, becomes z = L^{-1} l
  float* m = y + D;      // [D]: new mean
  float* part = m + D;   // [NT]: partial sums

  const int k = blockIdx.x, tid = threadIdx.x;
  const size_t off = (size_t)k * dd;
  const float eta = etas[k];
  const float inv_eta = 1.f / eta;
  // only the lower triangles of P and O are read: the elimination never
  // touches P's upper part, and O^T is upper triangular
  for (int idx = tid; idx < dd; idx += NT) {
    const int i = idx / D, c = idx - i * D;
    A[idx] = c <= i ? prec[off + idx] + rq[off + idx] * inv_eta : 0.f;
    R[idx] = c >= i ? oic[off + (size_t)c * D + i] : 0.f;
  }
  for (int i = tid; i < D; i += NT)
    y[i] = lin[(size_t)k * D + i] + rlin[(size_t)k * D + i] * inv_eta;
  __syncthreads();

  bool bad = !(eta > 0.f);
  float logdiag = 0.f;  // log|L|, kept by thread 0
  for (int j = 0; j < D && !bad; ++j) {
    const float piv = A[j * D + j];
    if (!(piv > 0.f)) {
      bad = true;  // every thread read the same pivot
      break;
    }
    const float inv_l = 1.f / sqrtf(piv);
    if (tid == 0) logdiag += 0.5f * logf(piv);
    __syncthreads();  // the pivot is read before column j is scaled
    for (int i = j + tid; i < D; i += NT) A[i * D + j] *= inv_l;
    for (int c = tid; c < D; c += NT) R[j * D + c] *= inv_l;
    if (tid == 0) y[j] *= inv_l;
    __syncthreads();
    const int rows = D - j - 1;
    for (int idx = tid; idx < rows * D; idx += NT) {
      const int i = j + 1 + idx / D, c = idx % D;
      const float lij = A[i * D + j];
      if (c > j && c <= i) A[i * D + c] -= lij * A[c * D + j];
      R[i * D + c] -= lij * R[j * D + c];
    }
    for (int i = j + 1 + tid; i < D; i += NT) y[i] -= A[i * D + j] * y[j];
    __syncthreads();
  }
  if (bad) {
    if (tid == 0) kl[k] = F32_MAX;
    return;
  }

  // back-substitution L^T m = z
  if (tid == 0) {
    for (int j = D - 1; j >= 0; --j) {
      float num = y[j];
      for (int i = j + 1; i < D; ++i) num -= A[i * D + j] * m[i];
      m[j] = num / A[j * D + j];
    }
  }
  __syncthreads();

  // trace ||Y||_F^2 plus Mahalanobis ||O (mean_old - m)||^2
  float acc = 0.f;
  for (int idx = tid; idx < dd; idx += NT) acc += R[idx] * R[idx];
  for (int i = tid; i < D; i += NT) {
    float od = 0.f;
    for (int c = 0; c <= i; ++c)
      od += oic[off + (size_t)i * D + c] * (means[(size_t)k * D + c] - m[c]);
    acc += od * od;
  }
  part[tid] = acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int t = 0; t < NT; ++t) total += part[t];
    kl[k] = 0.5f * (klconst[k] + 2.f * logdiag + total);
  }
}

}  // namespace

// kl [K]; all arrays float32, contiguous, on the current device; D <= 64.
extern "C" int gmmvi_tr_kl(const float* etas, const float* prec,
                           const float* rq, const float* lin,
                           const float* rlin, const float* old_inv_chols,
                           const float* means, const float* klconst,
                           float* kl, int K, int D, void* stream) {
  if (D < 1 || D > 64 || K < 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(2 * D * D + 2 * D + NT) * sizeof(float);
  tr_kl_kernel<<<K, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      etas, prec, rq, lin, rlin, old_inv_chols, means, klconst, kl, D);
  return (int)cudaGetLastError();
}
