// K-tiled mixture density passes for large D on Hopper (sm_90a): kernels B5
// (component densities and the mixture logsumexp) and B6 (the analytic
// mixture gradient).
//
// Replaces the TPU kernels gmmvi_tpu/ops/pallas_density_large.py
// `_density_kernel` (B5) and `_grad_kernel` (B6).  Python wrappers and plain
// versions: gmmvi_tpu_torch/ops/density_large.py.
//
// What bounds them on this card: fp32 FMAs.  At the stm300 shapes (K = 40,
// N = 12,000, D = 300) B5 whitens every sample against every factor,
// K N D(D+1)/2 = 2.2e10 FMAs, and B6 applies every precision, K N D^2 =
// 4.3e10, against ~15 MB of factors and samples: the arithmetic outweighs
// the bytes some hundred times.
//
// Why the small-D design (density.cu: one sample per thread, the factors
// resident in shared memory) does not carry over: at D = 300 one factor is
// 360 KB, more than a block's 227 KB of shared memory, and a thread cannot
// keep a 300-vector in registers.  So both passes are batched GEMMs with
// fused epilogues, each block one 64 x 64 output tile of simt_tile.cuh (64
// threads, 8 x 8 register micro-tiles, the reduction axis staged in slabs of
// 32; fp32 FMA, no TF32, no tensor cores).  Operands are staged slab by slab
// from global memory (L2 serves the re-reads), so a block needs 17 KB of
// shared memory and many blocks share an SM.
//
// B5, Y_k = L_k^{-1} (X - mu_k)^T: one block per (component k, 64-sample
// tile).  For each 64-row slab of L_k^{-1} it streams the 32-column slabs
// left of the diagonal only (the factor is lower triangular, which halves
// the FMAs), with the samples minus mu_k (subtracted before the whitening:
// the TPU kernel's bias fold W x - b cancels at |mu| ~ 100); it squares the
// finished rows into each sample's Mahalanobis sum and writes comp[k, n].
// The TPU kernel carries the mixture logsumexp over its sequential K axis;
// here blocks of one sample tile run in parallel on other SMs, so a second
// small kernel takes the logsumexp over comp's K rows (one thread per
// sample, online max and rescaled sum).  That buys K times more blocks
// (7,520 at stm300, against 188 sample tiles for 132 SMs) for one extra
// read of comp (K N floats, ~2 MB).  In the background mode rows with a
// -inf log weight are skipped outright (their blocks return at once), so the
// count-weighted background over U = 160 ring rows of which about half are
// live costs only the live half; comp is then scratch that the caller never
// sees.
//
// B6, grads[n] = -sum_k r_k(n) Lambda_k (x_n - mu_k) with r_k = exp(comp_k
// + log w_k - model) from B5's outputs and Lambda_k = L_k^{-T} L_k^{-1}
// formed by the wrapper: one block per (64-row slab of D, 64-sample tile)
// accumulates over every component and every 32-row slab of Lambda_k, the
// operand r_k(n) (x_n - mu_k) built while staging.  No reduction crosses
// blocks.  A component whose responsibilities underflow to zero on the whole
// tile is skipped (at stm300 the components lie far apart, so most are).
#include <math.h>

#include "simt_tile.cuh"

namespace {

using simt::NT;
using simt::S;
using simt::T;
using simt::TK;

constexpr float LOG_2PI = 1.8378770664093453f;
constexpr int MAX_D = 512;

// B5 pass 1: comp[k, n] for one (sample tile, component).
__global__ void __launch_bounds__(NT)
large_comp_kernel(const float* __restrict__ means,
                  const float* __restrict__ inv_chols,
                  const float* __restrict__ logw,
                  const float* __restrict__ logdets,
                  const float* __restrict__ xs, float* __restrict__ comp,
                  int N, int D, int skip_masked) {
  __shared__ __align__(16) float s_l[TK * S];  // s_l[j][i] = L[i0 + i][j0 + j]
  __shared__ __align__(16) float s_x[TK * S];  // s_x[j][n] = x[n][j0 + j] - mu
  const int k = blockIdx.y;
  // uniform over the block: a masked row of the background is not needed
  if (skip_masked && !(logw[k] > -INFINITY)) return;
  const int n0 = blockIdx.x * T;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const float* L = inv_chols + (size_t)k * D * D;
  const float* mu = means + (size_t)k * D;

  float maha[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < D; i0 += T) {
    float acc[8][8];
    simt::zero(acc);
    const int jend = min(i0 + T, D);  // L[i][j] = 0 for j > i
    for (int j0 = 0; j0 < jend; j0 += TK) {
      __syncthreads();  // the previous slab is read
      // global reads run along j (coalesced)
      for (int idx = tid; idx < TK * T; idx += NT) {
        const int i = idx / TK, j = idx % TK;
        const int gi = i0 + i, gj = j0 + j;
        // the lower triangle only: the upper one is never read
        s_l[j * S + i] = (gi < D && gj <= gi) ? L[(size_t)gi * D + gj] : 0.f;
        const int n = n0 + i;  // the same walk over (sample, column)
        s_x[j * S + i] =
            (gj < D && n < N) ? xs[(size_t)n * D + gj] - mu[gj] : 0.f;
      }
      __syncthreads();
      simt::slab_fma(s_l, s_x, acc, ty, tx);
    }
    // rows past D were staged as zeros and add nothing
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) maha[c] = fmaf(acc[r][c], acc[r][c], maha[c]);
  }

  // the 8 row groups' partial sums, added in a fixed order
  __syncthreads();
  float* s_red = s_l;  // [8][T]: the factor slab is no longer read
#pragma unroll
  for (int c = 0; c < 8; ++c) s_red[ty * T + simt::sub(tx, c)] = maha[c];
  __syncthreads();
  if (n0 + tid < N) {
    float m = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) m += s_red[t * T + tid];
    comp[(size_t)k * N + n0 + tid] =
        -0.5f * m + (-logdets[k] - 0.5f * (float)D * LOG_2PI);
  }
}

// B5 pass 2: model[n] = logsumexp_k(comp[k, n] + logw[k]) over the rows with
// a finite log weight; -inf where there is none (masked_logsumexp).
__global__ void large_lse_kernel(const float* __restrict__ comp,
                                 const float* __restrict__ logw,
                                 float* __restrict__ model, int K, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m = -INFINITY, s = 0.f;
  for (int k = 0; k < K; ++k) {
    const float lw = logw[k];
    if (!(lw > -INFINITY)) continue;
    const float w = comp[(size_t)k * N + n] + lw;
    if (w > m) {
      s = s * expf(m - w) + 1.f;
      m = w;
    } else if (w > -INFINITY) {
      s += expf(w - m);
    }
  }
  model[n] = s > 0.f ? m + logf(s) : -INFINITY;
}

// B6: grads for one (slab of 64 dimensions, sample tile), over every k.
__global__ void __launch_bounds__(NT)
large_grad_kernel(const float* __restrict__ lam,
                  const float* __restrict__ means,
                  const float* __restrict__ logw,
                  const float* __restrict__ comp,
                  const float* __restrict__ model,
                  const float* __restrict__ xs, float* __restrict__ grads,
                  int K, int N, int D) {
  // s_a[e][d] = Lambda[e0 + e][d0 + d], s_b[e][n] = r(n) (x[n][e0 + e] -
  // mu[e0 + e]); at the end the whole buffer holds the output tile
  __shared__ __align__(16) float s_ab[2 * TK * S];
  __shared__ float s_r[T];
  float* s_a = s_ab;
  float* s_b = s_ab + TK * S;
  const int n0 = blockIdx.x * T, d0 = blockIdx.y * T;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;

  float acc[8][8];
  simt::zero(acc);
  for (int k = 0; k < K; ++k) {
    const float lw = logw[k];
    if (!(lw > -INFINITY)) continue;  // uniform over the block
    float r = 0.f;
    const int n = n0 + tid;  // NT == T: one sample per thread
    if (n < N) {
      const float md = model[n];
      if (md > -INFINITY) r = expf(comp[(size_t)k * N + n] + lw - md);
    }
    s_r[tid] = r;
    // (also publishes s_r; the previous component's reads ended at the last
    // barrier of its slab loop) nothing of k on this tile: skip it
    if (!__syncthreads_or(r != 0.f)) continue;
    const float* lk = lam + (size_t)k * D * D;
    const float* mu = means + (size_t)k * D;
    for (int e0 = 0; e0 < D; e0 += TK) {
      for (int idx = tid; idx < TK * T; idx += NT) {
        // Lambda is symmetric: row e0 + e read along d (coalesced)
        const int e = idx / T, d = idx % T;
        const int ge = e0 + e, gd = d0 + d;
        s_a[e * S + d] = (ge < D && gd < D) ? lk[(size_t)ge * D + gd] : 0.f;
        // the samples read along e (coalesced)
        const int sn = idx / TK, se = idx % TK;
        const int gse = e0 + se;
        s_b[se * S + sn] = (gse < D && n0 + sn < N)
                               ? s_r[sn] * (xs[(size_t)(n0 + sn) * D + gse] -
                                            mu[gse])
                               : 0.f;
      }
      __syncthreads();
      simt::slab_fma(s_a, s_b, acc, ty, tx);
      __syncthreads();
    }
  }

  // transpose through shared memory so that rows of grads are written
  // along d (coalesced)
  float* s_out = s_ab;  // [T][S]
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      s_out[simt::sub(tx, c) * S + simt::sub(ty, r)] = -acc[r][c];
  __syncthreads();
  for (int idx = tid; idx < T * T; idx += NT) {
    const int n = idx / T, d = idx % T;
    if (n0 + n < N && d0 + d < D)
      grads[(size_t)(n0 + n) * D + d0 + d] = s_out[n * S + d];
  }
}

}  // namespace

// comp [K, N] (scratch in the background mode, where only the rows with a
// finite log weight are written) and model [N] from means [K, D], lower
// triangular inv_chols [K, D, D] (the upper triangle is not read), logw [K],
// logdets [K] and x [N, D]; all float32, contiguous, on the current device.
// 1 <= D <= 512, 1 <= K <= 65,535.
extern "C" int gmmvi_densities_large(const float* means,
                                     const float* inv_chols,
                                     const float* logw, const float* logdets,
                                     const float* x, float* comp,
                                     float* model, int K, int N, int D,
                                     int skip_masked, void* stream) {
  // K rides the grid's y axis (at most 65,535 blocks)
  if (K < 1 || K > 65535 || D < 1 || D > MAX_D || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + T - 1) / T, K);
  large_comp_kernel<<<grid, NT, 0, st>>>(means, inv_chols, logw, logdets, x,
                                         comp, N, D, skip_masked);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  large_lse_kernel<<<(N + 255) / 256, 256, 0, st>>>(comp, logw, model, K, N);
  return (int)cudaGetLastError();
}

// grads [N, D] from lam [K, D, D] (symmetric precisions), means [K, D],
// logw [K], comp [K, N] and model [N] (B5's outputs) and x [N, D]; all
// float32, contiguous, on the current device.  1 <= D <= 512, K >= 1.
extern "C" int gmmvi_density_grads_large(const float* lam, const float* means,
                                         const float* logw, const float* comp,
                                         const float* model, const float* x,
                                         float* grads, int K, int N, int D,
                                         void* stream) {
  if (K < 1 || D < 1 || D > MAX_D || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + T - 1) / T, (D + T - 1) / T);
  large_grad_kernel<<<grid, NT, 0, st>>>(lam, means, logw, comp, model, x,
                                         grads, K, N, D);
  return (int)cudaGetLastError();
}
