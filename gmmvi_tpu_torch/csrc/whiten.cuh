// Per-sample whitening against lower-triangular factors staged in shared
// memory: the helpers of density.cu (B1/B2).
//
// A thread owns one sample x and whitens it against one factor at a time,
// y = L^{-1}(x - mu), in plain fp32 FMA (no TF32, no tensor cores).  Each
// factor's lower triangle is staged row-major and packed (row i starts at
// i(i+1)/2).  Two instances of every loop over D: for D <= MAX_UNROLLED_D
// the bound is a constant and the loops unroll, so the per-thread vectors
// live in registers; above it run-time loops keep them in local memory
// (slower, but it compiles in seconds: unrolling that one is quadratic in D).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gmmvi {

constexpr float LOG_2PI = 1.8378770664093453f;
constexpr int MAX_UNROLLED_D = 32;

// v <- y = L^{-1}(x - mu) in place, rows from last to first: row i reads
// diff_0..diff_i, and rows below i have already stopped needing diff_i.
// Returns |y|^2.
template <int DMAX>
__device__ __forceinline__ float whiten(const float* __restrict__ tri,
                                        const float* __restrict__ mu,
                                        const float (&x)[DMAX],
                                        float (&v)[DMAX], int D) {
  float maha = 0.f;
  if constexpr (DMAX <= MAX_UNROLLED_D) {
#pragma unroll
    for (int j = 0; j < DMAX; ++j) {
      v[j] = 0.f;
      if (j < D) v[j] = x[j] - mu[j];
    }
#pragma unroll
    for (int i = DMAX - 1; i >= 0; --i) {
      if (i < D) {
        const float* row = tri + i * (i + 1) / 2;
        float yi = 0.f;
#pragma unroll
        for (int j = 0; j <= i; ++j) yi = fmaf(row[j], v[j], yi);
        v[i] = yi;
        maha = fmaf(yi, yi, maha);
      }
    }
  } else {
    for (int j = 0; j < D; ++j) v[j] = x[j] - mu[j];
    for (int i = D - 1; i >= 0; --i) {
      const float* row = tri + i * (i + 1) / 2;
      float yi = 0.f;
      for (int j = 0; j <= i; ++j) yi = fmaf(row[j], v[j], yi);
      v[i] = yi;
      maha = fmaf(yi, yi, maha);
    }
  }
  return maha;
}

// Stage rows c0..c0+nk of the factors, means, log|L| and log weights into
// shared memory; T = D(D+1)/2 floats of packed triangle per row.  Called by
// all `nthreads` threads of a block.
__device__ __forceinline__ void stage(const float* __restrict__ means,
                                      const float* __restrict__ inv_chols,
                                      const float* __restrict__ logw,
                                      const float* __restrict__ logdets,
                                      float* s_tri, float* s_mu, float* s_ld,
                                      float* s_lw, int c0, int nk, int D,
                                      int T, int tid, int nthreads) {
  const int dd = D * D;
  for (int idx = tid; idx < nk * dd; idx += nthreads) {
    const int c = idx / dd, r = idx - c * dd;
    const int i = r / D, j = r - i * D;
    if (j <= i)
      s_tri[c * T + i * (i + 1) / 2 + j] =
          inv_chols[(size_t)(c0 + c) * dd + r];
  }
  for (int idx = tid; idx < nk * D; idx += nthreads) {
    const int c = idx / D;
    s_mu[idx] = means[(size_t)(c0 + c) * D + (idx - c * D)];
  }
  for (int c = tid; c < nk; c += nthreads) {
    s_ld[c] = logdets[c0 + c];
    s_lw[c] = logw[c0 + c];
  }
}

}  // namespace gmmvi
