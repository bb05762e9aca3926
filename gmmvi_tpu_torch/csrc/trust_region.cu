// Batched trust-region KL evaluation and the whole bracket search over it,
// for Hopper (sm_90a): kernel B3.
//
// Replaces the TPU kernel gmmvi_tpu/ops/pallas_trust_region.py
// `_tr_kl_kernel` and the bracket loop around it,
// gmmvi_tpu/optimization/component_updaters.py `_bracketing_search_batched`.
// Python wrappers and plain versions: gmmvi_tpu_torch/ops/trust_region.py.
//
// For every component k at its own eta_k: P = old_prec + R_quad / eta,
// l = old_lin + R_lin / eta, the Cholesky factor L of P, the new mean
// P^{-1} l and KL(new || old) = 0.5 (kl_const + log|P| + ||L^{-1} O^T||_F^2
// + ||O (mean_old - mean_new)||^2), with O the old inverse Cholesky factor.
// eta <= 0 or a non-positive pivot gives F32_MAX.
//
// What bounds it on this card: neither bytes nor FMAs.  At the main path's
// shape (K=48, D=20) one KL evaluation reads ~0.13 MB (the lower triangles
// of the old precision, R_quad and O, and the vectors) and does ~0.6 MFLOP,
// a fraction of a microsecond of either; it is as long as the D sequential
// elimination steps, each a pair of block barriers.  What a search costs
// besides is the host: run as a host loop, each trip is one launch, some
// thirty small torch operations and one read of an "all done" flag.
//
// Design: one block per component, the D x D matrix P and the right-hand
// side O^T in shared memory (tr_kl_body).  A right-looking Cholesky scales
// column j, then updates the trailing lower triangle with block-wide
// parallelism; the two forward solves the KL needs (L z = l for the mean,
// L Y = O^T for the trace term) ride along inside the same elimination, as
// on the TPU, so there is no separate solve pass.  The back-substitution
// L^T m = z is D^2 FMAs on one thread, and the trace and Mahalanobis sums
// reduce in a fixed order.
//
// Two entries share that body.  tr_kl_kernel evaluates the KL once at given
// etas (the per-trip form, kept as the reference the search is held to).
// tr_search_kernel runs each component's log-space bisection to its end in
// its own block: a component's bracket depends on its own KL alone, so the
// lockstep host loop and K independent loops give the same etas.  The
// block keeps its old precision, R_quad and O resident in shared memory
// (5 D^2 floats, 80 KB at D = 64) and repeats the host loop's float32
// arithmetic step for step: eta = 0.5 (lower + upper), expf (no fast-math
// intrinsics: the build has no --use_fast_math, as PyTorch's exp), the
// stop-width and |KL - bound| < 0.1 bound tests, the masked updates in the
// order of the torch.where chain, the 1000-trip cap; every thread of the
// block runs the same scalar steps, so only the KL is broadcast.  Products
// that the host loop rounds on their own are written as __fmul_rn /
// __fsub_rn, which nvcc never contracts into an FMA.  One launch replaces
// the trips' launches and their flag reads, and the etas are equal to the
// bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;
constexpr int MAX_TRIPS = 1000;
constexpr float F32_MAX = 3.4028234663852886e38f;

// KL(new(eta) || old) for one component, returned to every thread of the
// block.  prec, rq, oic: [D, D] (lower triangles read), lin, rlin, mean:
// [D], anywhere in memory; A, R: [D, D], y, m: [D], part: [NT + 1] of
// shared scratch.
__device__ __forceinline__ float tr_kl_body(
    float eta, const float* prec, const float* rq, const float* lin,
    const float* rlin, const float* oic, const float* mean, float klconst,
    float* A, float* R, float* y, float* m, float* part, int D) {
  const int dd = D * D, tid = threadIdx.x;
  const float inv_eta = 1.f / eta;
  // the block's previous readers of the scratch are done
  __syncthreads();
  // only the lower triangles of P and O are read: the elimination never
  // touches P's upper part, and O^T is upper triangular
  for (int idx = tid; idx < dd; idx += NT) {
    const int i = idx / D, c = idx - i * D;
    A[idx] = c <= i ? prec[idx] + rq[idx] * inv_eta : 0.f;
    R[idx] = c >= i ? oic[c * D + i] : 0.f;
  }
  for (int i = tid; i < D; i += NT) y[i] = lin[i] + rlin[i] * inv_eta;
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
  if (bad) return F32_MAX;  // uniform over the block

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
    for (int c = 0; c <= i; ++c) od += oic[i * D + c] * (mean[c] - m[c]);
    acc += od * od;
  }
  part[tid] = acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int t = 0; t < NT; ++t) total += part[t];
    part[NT] = 0.5f * (klconst + 2.f * logdiag + total);
  }
  __syncthreads();
  return part[NT];
}

// floats of tr_kl_body's scratch
__host__ __device__ inline int body_floats(int D) {
  return 2 * D * D + 2 * D + NT + 1;
}

__global__ void __launch_bounds__(NT)
tr_kl_kernel(const float* __restrict__ etas, const float* __restrict__ prec,
             const float* __restrict__ rq, const float* __restrict__ lin,
             const float* __restrict__ rlin, const float* __restrict__ oic,
             const float* __restrict__ means,
             const float* __restrict__ klconst, float* __restrict__ kl,
             int D) {
  extern __shared__ float sm[];
  const int dd = D * D, k = blockIdx.x;
  const size_t off = (size_t)k * dd;
  float* A = sm;
  float* R = A + dd;
  float* y = R + dd;
  float* m = y + D;
  const float v = tr_kl_body(etas[k], prec + off, rq + off,
                             lin + (size_t)k * D, rlin + (size_t)k * D,
                             oic + off, means + (size_t)k * D, klconst[k], A,
                             R, y, m, m + D, D);
  if (threadIdx.x == 0) kl[k] = v;
}

// torch.minimum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__global__ void __launch_bounds__(NT)
tr_search_kernel(const float* __restrict__ prec, const float* __restrict__ rq,
                 const float* __restrict__ lin, const float* __restrict__ rlin,
                 const float* __restrict__ oic,
                 const float* __restrict__ means,
                 const float* __restrict__ klconst,
                 const float* __restrict__ kl_bound,
                 const float* __restrict__ lower0,
                 const float* __restrict__ upper0,
                 const bool* __restrict__ active,
                 float* __restrict__ exp_lower, float* __restrict__ exp_upper,
                 int* __restrict__ trips_out, int D) {
  extern __shared__ float sm[];
  const int dd = D * D, k = blockIdx.x, tid = threadIdx.x;
  const size_t off = (size_t)k * dd;
  float* s_prec = sm;  // resident: [D, D] x 3, [D] x 3
  float* s_rq = s_prec + dd;
  float* s_oic = s_rq + dd;
  float* s_lin = s_oic + dd;
  float* s_rlin = s_lin + D;
  float* s_mean = s_rlin + D;
  float* A = s_mean + D;  // the body's scratch
  float* R = A + dd;
  float* y = R + dd;
  float* m = y + D;
  float lower = lower0[k], upper = upper0[k];
  bool upper_ok = false, done = !active[k];
  int trips = 0;
  if (!done) {
    // lower triangles only; the upper parts are never read
    for (int idx = tid; idx < dd; idx += NT) {
      const int i = idx / D, c = idx - i * D;
      if (c <= i) {
        s_prec[idx] = prec[off + idx];
        s_rq[idx] = rq[off + idx];
        s_oic[idx] = oic[off + idx];
      }
    }
    for (int i = tid; i < D; i += NT) {
      s_lin[i] = lin[(size_t)k * D + i];
      s_rlin[i] = rlin[(size_t)k * D + i];
      s_mean[i] = means[(size_t)k * D + i];
    }
    // (the body's first barrier publishes them)
  }
  const float bound = kl_bound[k], kc = klconst[k];
  const float tol = __fmul_rn(0.1f, bound);
  while (!done && trips < MAX_TRIPS) {
    const float eta = __fmul_rn(0.5f, __fadd_rn(lower, upper));
    const float e_eta = expf(eta);
    const float kl = tr_kl_body(e_eta, s_prec, s_rq, s_lin, s_rlin, s_oic,
                                s_mean, kc, A, R, y, m, m + D, D);
    const float diff = nan_min(__fsub_rn(expf(upper), e_eta),
                               __fsub_rn(e_eta, expf(lower)));
    const bool stop_width = diff < 0.1f;
    const bool good = fabsf(__fsub_rn(bound, kl)) < tol;
    const bool go_low = bound > kl;
    const float new_lower =
        stop_width ? lower : (good ? eta : (go_low ? lower : eta));
    const float new_upper =
        stop_width ? upper : (good ? eta : (go_low ? eta : upper));
    if (!stop_width && !good) upper_ok = upper_ok || go_low;
    lower = new_lower;
    upper = new_upper;
    done = stop_width || good;
    ++trips;
  }
  if (tid == 0) {
    exp_lower[k] = expf(upper_ok ? upper : lower);
    exp_upper[k] = expf(upper);
    trips_out[k] = trips;
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
  const size_t smem = (size_t)body_floats(D) * sizeof(float);
  tr_kl_kernel<<<K, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      etas, prec, rq, lin, rlin, old_inv_chols, means, klconst, kl, D);
  return (int)cudaGetLastError();
}

// The bracket search of every component with active[k] (bool), from its
// bracket [lower0[k], upper0[k]] (log space) against kl_bound[k]:
// exp_lower [K] (exp(upper) where the search stopped on an upper end that
// met the bound), exp_upper [K] and trips [K] (int32).  Inputs as
// gmmvi_tr_kl's; float32 unless stated, contiguous, on the current device;
// D <= 64.
extern "C" int gmmvi_tr_search(const float* prec, const float* rq,
                               const float* lin, const float* rlin,
                               const float* old_inv_chols, const float* means,
                               const float* klconst, const float* kl_bound,
                               const float* lower0, const float* upper0,
                               const bool* active, float* exp_lower,
                               float* exp_upper, int* trips, int K, int D,
                               void* stream) {
  if (D < 1 || D > 64 || K < 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  const size_t smem =
      (size_t)(3 * D * D + 3 * D + body_floats(D)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tr_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tr_search_kernel<<<K, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      prec, rq, lin, rlin, old_inv_chols, means, klconst, kl_bound, lower0,
      upper0, active, exp_lower, exp_upper, trips, D);
  return (int)cudaGetLastError();
}
