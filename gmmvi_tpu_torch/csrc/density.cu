// Mixture density passes for Hopper (sm_90a): kernels B1 and B2.
//
// Replaces the TPU kernels gmmvi_tpu/ops/pallas_density.py
// `_density_pack_kernel` (B1: component log-densities, mixture logsumexp and
// analytic mixture gradients) and `_densities_kernel` (B2: the first two
// only).  Python wrapper and plain version: gmmvi_tpu_torch/ops/density.py.
//
// What bounds it on this card: fp32 FMAs.  Per sample and component one
// pass whitens with the lower-triangular factor, D(D+1)/2 FMAs; B1 adds a
// second, L^T y, for the gradient.  At the main path's shape (K=48, D=20,
// N=9600) that is ~0.19 GFLOP per pass against ~3.5 MB of inputs and
// outputs, so the arithmetic outweighs the bytes by far.
//
// Design: the TPU kernel stacks all components into one [K*D, D] matmul and
// centres x and the means globally to survive the bias fold W1 x - b1.  Here
// each thread owns one sample and whitens it directly, y = L_k^{-1}(x - mu_k),
// in plain fp32 FMA (no TF32, no tensor cores), so neither the stacking nor
// the centring is needed.  A block is 32 samples x 4 component groups: the
// groups split the components, which quadruples the threads in flight at
// N=9600.  Component parameters (the factor's lower triangle, mu, log|L|,
// log w) are staged in shared memory in chunks that fit 44 KB, so any K
// works.  Pass 1 writes comp[k, n] (coalesced along n) and keeps an online
// max/sum per thread; the groups' partial logsumexps are combined through
// shared memory.  B1's pass 2 recomputes y_k, forms r_k = exp(comp_k +
// log w_k - model) and accumulates L_k^{-T}(r_k y_k); the groups' partial
// gradients are summed in a fixed order in shared memory and written out
// coalesced.  Two instances: for D <= 32 the dimension's bound is 32 and
// every loop over it is unrolled with a guard, so the per-thread vectors live
// in registers; for 32 < D <= 128 run-time loops keep them in local memory
// (slower, but it compiles in seconds: unrolling that one is quadratic in D);
// both live in whiten.cuh.
#include "whiten.cuh"

namespace {

using gmmvi::LOG_2PI;
using gmmvi::MAX_UNROLLED_D;
using gmmvi::whiten;

constexpr int TS = 32;  // samples per block (threadIdx.x)
constexpr int G = 4;    // component groups per block (threadIdx.y)
constexpr int NT = TS * G;
constexpr int PARAM_BUDGET_FLOATS = 11 * 1024;  // 44 KB of staged parameters

// acc += L^T (r y) with y in v.
template <int DMAX>
__device__ __forceinline__ void add_back(const float* __restrict__ tri,
                                         const float (&v)[DMAX], float r,
                                         float (&acc)[DMAX], int D) {
  if constexpr (DMAX <= MAX_UNROLLED_D) {
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < D) {
        const float ri = r * v[i];
        const float* row = tri + i * (i + 1) / 2;
#pragma unroll
        for (int j = 0; j <= i; ++j) acc[j] = fmaf(row[j], ri, acc[j]);
      }
    }
  } else {
    for (int i = 0; i < D; ++i) {
      const float ri = r * v[i];
      const float* row = tri + i * (i + 1) / 2;
      for (int j = 0; j <= i; ++j) acc[j] = fmaf(row[j], ri, acc[j]);
    }
  }
}

template <int DMAX, bool GRADS>
__global__ void __launch_bounds__(NT)
density_kernel(const float* __restrict__ means,
               const float* __restrict__ inv_chols,
               const float* __restrict__ logw,
               const float* __restrict__ logdets,
               const float* __restrict__ xs, float* __restrict__ comp,
               float* __restrict__ model, float* __restrict__ grads, int K,
               int N, int D, int kc) {
  extern __shared__ float smem[];
  const int T = D * (D + 1) / 2;
  float* s_tri = smem;
  float* s_mu = s_tri + kc * T;
  float* s_ld = s_mu + kc * D;
  float* s_lw = s_ld + kc;

  const int tx = threadIdx.x, g = threadIdx.y, tid = g * TS + tx;
  const int n = blockIdx.x * TS + tx;
  const bool valid = n < N;

  // loops linear in D run to DMAX with a guard and unroll: the unrolled
  // instances then index x, v and acc with constants only
  float x[DMAX], v[DMAX];
#pragma unroll
  for (int j = 0; j < DMAX; ++j)
    x[j] = (valid && j < D) ? xs[(size_t)n * D + j] : 0.f;
  const float cst = -0.5f * (float)D * LOG_2PI;

  // ---- pass 1: component log-densities + online logsumexp --------------
  float m = -INFINITY, s = 0.f;
  for (int c0 = 0; c0 < K; c0 += kc) {
    const int nk = min(kc, K - c0);
    __syncthreads();
    gmmvi::stage(means, inv_chols, logw, logdets, s_tri, s_mu, s_ld, s_lw,
                 c0, nk, D, T, tid, NT);
    __syncthreads();
    for (int c = g; c < nk; c += G) {
      const float maha = whiten<DMAX>(s_tri + c * T, s_mu + c * D, x, v, D);
      const float cv = -0.5f * maha - s_ld[c] + cst;
      if (valid) comp[(size_t)(c0 + c) * N + n] = cv;
      const float lw = s_lw[c];
      if (lw > -INFINITY) {
        const float w = cv + lw;
        if (w > m) {
          s = s * expf(m - w) + 1.f;
          m = w;
        } else {
          s += expf(w - m);
        }
      }
    }
  }

  // combine the groups' partial logsumexps (fixed order)
  __syncthreads();
  float* red_m = smem;
  float* red_s = smem + NT;
  red_m[tid] = m;
  red_s[tid] = s;
  __syncthreads();
  float mx = -INFINITY;
#pragma unroll
  for (int gg = 0; gg < G; ++gg) mx = fmaxf(mx, red_m[gg * TS + tx]);
  float sum = 0.f;
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    const float mg = red_m[gg * TS + tx];
    if (mg > -INFINITY) sum += red_s[gg * TS + tx] * expf(mg - mx);
  }
  const float mod = sum > 0.f ? mx + logf(sum) : -INFINITY;
  if (valid && g == 0) model[n] = mod;

  if constexpr (GRADS) {
    // ---- pass 2: grads = -sum_k r_k L_k^{-T} y_k ------------------------
    float acc[DMAX];
#pragma unroll
    for (int j = 0; j < DMAX; ++j) acc[j] = 0.f;
    for (int c0 = 0; c0 < K; c0 += kc) {
      const int nk = min(kc, K - c0);
      __syncthreads();
      gmmvi::stage(means, inv_chols, logw, logdets, s_tri, s_mu, s_ld, s_lw,
                   c0, nk, D, T, tid, NT);
      __syncthreads();
      for (int c = g; c < nk; c += G) {
        const float* tri = s_tri + c * T;
        const float maha = whiten<DMAX>(tri, s_mu + c * D, x, v, D);
        const float cv = -0.5f * maha - s_ld[c] + cst;
        const float lw = s_lw[c];
        if (lw > -INFINITY && mod > -INFINITY)
          add_back<DMAX>(tri, v, expf(cv + lw - mod), acc, D);
      }
    }
    // sum the groups' partial gradients in a fixed order
    __syncthreads();
    float* red = smem;  // [TS, D]
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < DMAX; ++j)
        if (j < D) red[tx * D + j] = acc[j];
    }
    __syncthreads();
    for (int gg = 1; gg < G; ++gg) {
      if (g == gg) {
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
          if (j < D) red[tx * D + j] += acc[j];
      }
      __syncthreads();
    }
    const int base = blockIdx.x * TS;
    const int rows = min(TS, N - base);
    for (int idx = tid; idx < rows * D; idx += NT)
      grads[(size_t)base * D + idx] = -red[idx];
  }
}

template <int DMAX>
cudaError_t launch(const float* means, const float* inv_chols,
                   const float* logw, const float* logdets, const float* x,
                   float* comp, float* model, float* grads, int K, int N,
                   int D, cudaStream_t stream) {
  const int per = D * (D + 1) / 2 + D + 2;
  const int kc = max(1, min(K, PARAM_BUDGET_FLOATS / per));
  size_t floats = (size_t)kc * per;
  if (floats < (size_t)2 * NT) floats = 2 * NT;
  if (floats < (size_t)TS * D) floats = (size_t)TS * D;
  const dim3 grid((N + TS - 1) / TS), block(TS, G);
  if (grads != nullptr)
    density_kernel<DMAX, true><<<grid, block, floats * sizeof(float),
                                 stream>>>(means, inv_chols, logw, logdets, x,
                                           comp, model, grads, K, N, D, kc);
  else
    density_kernel<DMAX, false><<<grid, block, floats * sizeof(float),
                                  stream>>>(means, inv_chols, logw, logdets,
                                            x, comp, model, nullptr, K, N, D,
                                            kc);
  return cudaGetLastError();
}

}  // namespace

// comp [K, N], model [N] and, when grads is not null, grads [N, D]; all
// arrays float32, contiguous, on the current device.  1 <= D <= 128, K >= 1.
extern "C" int gmmvi_density(const float* means, const float* inv_chols,
                             const float* logw, const float* logdets,
                             const float* x, float* comp, float* model,
                             float* grads, int K, int N, int D,
                             void* stream) {
  if (K < 1 || D < 1 || D > 128 || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= MAX_UNROLLED_D)
    return (int)launch<MAX_UNROLLED_D>(means, inv_chols, logw, logdets, x,
                                       comp, model, grads, K, N, D, st);
  return (int)launch<128>(means, inv_chols, logw, logdets, x, comp, model,
                          grads, K, N, D, st);
}
