// Count-weighted background mixture density for Hopper (sm_90a): kernel B4.
//
// Replaces the TPU kernel gmmvi_tpu/ops/pallas_density.py
// `_background_kernel` (entry `fused_background_logpdf`).  Python wrapper and
// plain version: gmmvi_tpu_torch/ops/background.py.  For U generating
// distributions given by means [U, D], lower-triangular inverse Cholesky
// factors [U, D, D], log weights [U] (-inf marks a row that is not selected)
// and log|L_u| [U], over samples x [N, D]:
//
//   bg[n] = logsumexp_u ( log N(x_n; mu_u, Sigma_u) + logw_u )
//
// over the rows with a finite log weight, and -inf where there is none (as
// the XLA chain and masked_logsumexp give; the TPU kernel returns a large
// negative float there instead).
//
// What bounds it on this card: fp32 FMAs.  Each live row whitens every
// sample, D(D+1)/2 FMAs; at the reuse path's shape (U = 192 rows of which
// about two thirds are live, N = 28,800, D = 20) that is ~0.8 GFMA against
// ~3 MB of inputs and outputs.
//
// Design: B2's first pass without its [U, N] output.  One thread owns one
// sample and keeps the TPU kernel's online max / rescaled sum in registers; a
// block is 32 samples x 4 row groups, and the groups' partial sums are
// combined through shared memory in a fixed order.  First one warp lists the
// live rows (finite log weight) in shared memory with ballots, so masked rows
// are never staged or whitened: the caller passes all U rows, and the TPU
// path's two-size ladder (2 Kmax or U rows, chosen by the live count) is not
// needed.  The live rows' factors are staged in shared memory a chunk at a
// time.  No N chunking: the TPU chunked N only for its VMEM.
#include "whiten.cuh"

namespace {

using gmmvi::LOG_2PI;
using gmmvi::MAX_UNROLLED_D;
using gmmvi::whiten;

constexpr int TS = 32;  // samples per block (threadIdx.x)
constexpr int G = 4;    // row groups per block (threadIdx.y)
constexpr int NT = TS * G;
constexpr int PARAM_BUDGET_FLOATS = 11 * 1024;  // 44 KB of staged rows

template <int DMAX>
__global__ void __launch_bounds__(NT)
background_kernel(const float* __restrict__ means,
                  const float* __restrict__ inv_chols,
                  const float* __restrict__ logw,
                  const float* __restrict__ logdets,
                  const float* __restrict__ xs, float* __restrict__ out,
                  int U, int N, int D, int kc, int rows_floats) {
  extern __shared__ float smem[];
  __shared__ int s_nlive;
  const int T = D * (D + 1) / 2;
  int* s_rows = reinterpret_cast<int*>(smem);
  float* s_tri = smem + rows_floats;
  float* s_mu = s_tri + kc * T;
  float* s_ld = s_mu + kc * D;
  float* s_lw = s_ld + kc;

  const int tx = threadIdx.x, g = threadIdx.y, tid = g * TS + tx;
  const int n = blockIdx.x * TS + tx;
  const bool valid = n < N;

  // the live rows, in order
  if (tid < 32) {
    int count = 0;
    for (int base = 0; base < U; base += 32) {
      const int u = base + tid;
      const bool live = u < U && logw[u] > -INFINITY;
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (live) s_rows[count + __popc(bal & ((1u << tid) - 1u))] = u;
      count += __popc(bal);
    }
    if (tid == 0) s_nlive = count;
  }

  float x[DMAX], v[DMAX];
#pragma unroll
  for (int j = 0; j < DMAX; ++j)
    x[j] = (valid && j < D) ? xs[(size_t)n * D + j] : 0.f;
  const float cst = -0.5f * (float)D * LOG_2PI;
  __syncthreads();
  const int nlive = s_nlive;

  float m = -INFINITY, s = 0.f;
  for (int c0 = 0; c0 < nlive; c0 += kc) {
    const int nk = min(kc, nlive - c0);
    __syncthreads();
    gmmvi::stage(means, inv_chols, logw, logdets, s_rows + c0, s_tri, s_mu,
                 s_ld, s_lw, 0, nk, D, T, tid, NT);
    __syncthreads();
    for (int c = g; c < nk; c += G) {
      const float maha = whiten<DMAX>(s_tri + c * T, s_mu + c * D, x, v, D);
      const float w = -0.5f * maha - s_ld[c] + cst + s_lw[c];
      if (!(w > -INFINITY)) continue;
      if (w > m) {
        s = s * expf(m - w) + 1.f;
        m = w;
      } else {
        s += expf(w - m);
      }
    }
  }

  // combine the groups' partial logsumexps (fixed order)
  __syncthreads();
  float* red_m = smem + rows_floats;
  float* red_s = red_m + NT;
  red_m[tid] = m;
  red_s[tid] = s;
  __syncthreads();
  if (g != 0 || !valid) return;
  float mx = -INFINITY;
#pragma unroll
  for (int gg = 0; gg < G; ++gg) mx = fmaxf(mx, red_m[gg * TS + tx]);
  float sum = 0.f;
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    const float mg = red_m[gg * TS + tx];
    if (mg > -INFINITY) sum += red_s[gg * TS + tx] * expf(mg - mx);
  }
  out[n] = sum > 0.f ? mx + logf(sum) : -INFINITY;
}

template <int DMAX>
cudaError_t launch(const float* means, const float* inv_chols,
                   const float* logw, const float* logdets, const float* x,
                   float* out, int U, int N, int D, cudaStream_t stream) {
  const int per = D * (D + 1) / 2 + D + 2;
  const int rows_floats = (U + 3) / 4 * 4;  // int list, 16-byte aligned
  const int kc = max(1, min(max(U, 1), PARAM_BUDGET_FLOATS / per));
  size_t floats = (size_t)kc * per;
  if (floats < (size_t)2 * NT) floats = 2 * NT;
  const size_t bytes = (rows_floats + floats) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        background_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + TS - 1) / TS), block(TS, G);
  background_kernel<DMAX><<<grid, block, bytes, stream>>>(
      means, inv_chols, logw, logdets, x, out, U, N, D, kc, rows_floats);
  return cudaGetLastError();
}

}  // namespace

// out [N]; all arrays float32, contiguous, on the current device.
// 1 <= D <= 128, U >= 0.
extern "C" int gmmvi_background(const float* means, const float* inv_chols,
                                const float* logw, const float* logdets,
                                const float* x, float* out, int U, int N,
                                int D, void* stream) {
  if (U < 0 || D < 1 || D > 128 || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= MAX_UNROLLED_D)
    return (int)launch<MAX_UNROLLED_D>(means, inv_chols, logw, logdets, x,
                                       out, U, N, D, st);
  return (int)launch<128>(means, inv_chols, logw, logdets, x, out, U, N, D,
                          st);
}
