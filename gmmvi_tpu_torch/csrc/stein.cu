// Streamed Stein second moments for Hopper (sm_90a): kernel B7.
//
// Replaces the TPU kernel gmmvi_tpu/ops/pallas_stein.py `_smom_kernel`
// (entry `fused_stein_smom`).  Python wrapper and plain version:
// gmmvi_tpu_torch/ops/stein.py.  For every component k:
//
//   s_mom[k] = sum_n w[k, n] g[n, :] xc[n, :]^T          [D, D]
//
// with w the self-normalized importance weights, g the log-ratio gradients
// and xc the samples minus the centring shift.
//
// What bounds it on this card: fp32 FMAs, K N D^2 = 4.3e10 at the stm300
// shapes (K = 40, N = 12,000, D = 300) against ~31 MB of inputs and output.
//
// Design: the moment is a batched GEMM (w_k o G)^T Xc whose operand w_k o G
// the plain PyTorch form materializes as a [K, N, D] array (576 MB at
// stm300) or, as the port's first moment form did, an [N, D, D] outer
// product (4.3 GB).  Here one block of 64 threads owns one (component,
// 64 x 64 tile of the D x D output): 40 x 25 = 1,000 blocks at stm300.  It
// walks N in slabs of 32 samples, stages (w_k o G)[slab, d-tile] (the
// weight folded in while staging) and Xc[slab, e-tile] in shared memory, and
// accumulates with the 8 x 8 register micro-tiles of simt_tile.cuh.  Only
// the [K, D, D] moments reach device memory.  A slab in which the
// component's weights are all zero adds nothing and is skipped; that changes
// no value (padded slots and invalid samples carry weight 0, and at stm300
// self-normalized weights of far-apart components underflow to 0).
#include "simt_tile.cuh"

namespace {

using simt::NT;
using simt::S;
using simt::T;
using simt::TK;

constexpr int MAX_D = 512;

__global__ void __launch_bounds__(NT)
stein_smom_kernel(const float* __restrict__ w, const float* __restrict__ g,
                  const float* __restrict__ xc, float* __restrict__ out,
                  int N, int D, int ntiles) {
  __shared__ __align__(16) float s_a[TK * S];  // w[k, n] g[n, d0 + d]
  __shared__ __align__(16) float s_b[TK * S];  // xc[n, e0 + e]
  __shared__ float s_w[TK];
  const int k = blockIdx.y;
  const int d0 = (blockIdx.x / ntiles) * T, e0 = (blockIdx.x % ntiles) * T;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const float* wk = w + (size_t)k * N;

  float acc[8][8];
  simt::zero(acc);
  for (int n0 = 0; n0 < N; n0 += TK) {
    const int nc = min(TK, N - n0);
    float wt = 0.f;
    if (tid < TK) {
      wt = tid < nc ? wk[n0 + tid] : 0.f;
      s_w[tid] = wt;
    }
    // (also ends the previous slab's reads of shared memory and publishes
    // s_w) a slab without weight adds nothing
    if (!__syncthreads_or(wt != 0.f)) continue;
    for (int idx = tid; idx < TK * T; idx += NT) {
      const int n = idx / T, d = idx % T;
      const bool in = n < nc;
      const size_t row = (size_t)(n0 + n) * D;
      s_a[n * S + d] = (in && d0 + d < D) ? s_w[n] * g[row + d0 + d] : 0.f;
      s_b[n * S + d] = (in && e0 + d < D) ? xc[row + e0 + d] : 0.f;
    }
    __syncthreads();
    simt::slab_fma(s_a, s_b, acc, ty, tx);
  }

  float* ok = out + (size_t)k * D * D;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int d = d0 + simt::sub(ty, r);
    if (d >= D) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int e = e0 + simt::sub(tx, c);
      if (e < D) ok[(size_t)d * D + e] = acc[r][c];
    }
  }
}

}  // namespace

// out [K, D, D] from w [K, N], g [N, D] and xc [N, D]; all float32,
// contiguous, on the current device.  1 <= D <= 512, 1 <= K <= 65,535.
extern "C" int gmmvi_stein_smom(const float* w, const float* g,
                                const float* xc, float* out, int K, int N,
                                int D, void* stream) {
  // K rides the grid's y axis (at most 65,535 blocks)
  if (K < 1 || K > 65535 || D < 1 || D > MAX_D || N < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (D + T - 1) / T;
  const dim3 grid(ntiles * ntiles, K);
  stein_smom_kernel<<<grid, NT, 0, st>>>(w, g, xc, out, N, D, ntiles);
  return (int)cudaGetLastError();
}
