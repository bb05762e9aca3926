// Weighted normal equations of the MORE quadratic fit for Hopper (sm_90a):
// kernel B8.
//
// Replaces the TPU kernel gmmvi_tpu/ops/pallas_more.py `_more_gram_kernel`
// (entry `fused_more_grams`).  Python wrapper and plain version:
// gmmvi_tpu_torch/ops/more.py.  For every component k, with whitened samples
// z = L_k^{-1}(x_n - mu_k) and the F = D(D+1)/2 + D + 1 quadratic features
// f(z) = [z_i z_j (i <= j, row by row), z, 1] (the reference's order):
//
//   gram[k] = sum_n w[k, n] f f^T   [F, F]      rhs[k] = sum_n w[k, n] y_n f
//
// What bounds it on this card: fp32 FMAs.  At the reuse path's shape (K = 48,
// N = 28,800, D = 20, F = 231) the Gram alone is ~37 GFMA against ~5 MB of
// inputs and ~10 MB of outputs.
//
// Design: one component's Gram is 231^2 fp32 = 213 KB at D = 20 (and 4.7 MB
// at the envelope's D = 45), too much to keep whole in shared memory.  So the
// output is tiled: the features are extended by one column, y (the rhs is
// then the Gram's last column), padded to tiles of TF = 64, and one block
// computes one (component, tile a <= tile b) pair of the upper triangle of
// tiles, streaming N in chunks of NC = 32 samples.  Per chunk the block
// stages x, w and y, whitens the chunk (each thread a few (sample, row)
// pairs, D(D+1)/2 FMAs per sample: small next to the tile's NC * TF^2),
// builds the chunk's feature rows for its two tiles from a precomputed
// feature -> (i, j) table (w folded into tile a's), and accumulates a 4 x 4
// register tile per thread from float4 loads.  A chunk whose weights are all
// zero is skipped.  Blocks off the diagonal also write the mirrored tile.  All
// sums in fp32 FMA, no TF32: the ridge is 1e-12, so the Gram's rounding
// reaches the solve.
#include <cuda_runtime.h>

namespace {

constexpr int TF = 64;  // features per tile side
constexpr int NC = 32;  // samples per chunk
constexpr int TPB = 16; // threads per tile side; each owns 4 x 4 outputs
constexpr int NT = TPB * TPB;
constexpr int MAX_D = 45;
constexpr int ZW = MAX_D + 3;  // z, then 1, y and 0

// Extended feature f -> indices (i, j) into [z_0..z_{D-1}, 1, y, 0] whose
// product is the feature: z_i z_j (i <= j), z_i, 1, y, then zero padding.
__device__ __forceinline__ void feature_pair(int f, int D, int& i, int& j) {
  const int T = D * (D + 1) / 2;
  if (f < T) {
    int r = 0, start = 0;
    while (start + (D - r) <= f) {
      start += D - r;
      ++r;
    }
    i = r;
    j = r + (f - start);
  } else if (f < T + D) {
    i = f - T;
    j = D;
  } else if (f == T + D) {
    i = D;
    j = D;
  } else if (f == T + D + 1) {
    i = D + 1;
    j = D;
  } else {
    i = D + 2;
    j = D + 2;
  }
}

__global__ void __launch_bounds__(NT)
more_gram_kernel(const float* __restrict__ inv_chols,
                 const float* __restrict__ means, const float* __restrict__ w,
                 const float* __restrict__ y, const float* __restrict__ xs,
                 float* __restrict__ gram, float* __restrict__ rhs, int N,
                 int D, int F, int ntiles) {
  __shared__ float s_l[MAX_D * MAX_D];
  __shared__ float s_mu[MAX_D];
  __shared__ float s_x[NC * MAX_D];
  __shared__ float s_w[NC];
  __shared__ float s_z[NC * ZW];
  __shared__ int s_fi[2][TF], s_fj[2][TF];
  __shared__ __align__(16) float s_fa[NC][TF];
  __shared__ __align__(16) float s_fb[NC][TF];

  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % TPB, ty = tid / TPB;

  // this block's tile pair (a <= b) from its index
  int a = 0, p = blockIdx.x;
  while (p >= ntiles - a) {
    p -= ntiles - a;
    ++a;
  }
  const int b = a + p;

  const int dd = D * D;
  for (int idx = tid; idx < dd; idx += NT)
    s_l[idx] = inv_chols[(size_t)k * dd + idx];
  for (int idx = tid; idx < D; idx += NT) s_mu[idx] = means[(size_t)k * D + idx];
  for (int idx = tid; idx < 2 * TF; idx += NT) {
    const int side = idx / TF, f = idx % TF;
    int i, j;
    feature_pair((side ? b : a) * TF + f, D, i, j);
    s_fi[side][f] = i;
    s_fj[side][f] = j;
  }

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  const float* wk = w + (size_t)k * N;
  for (int n0 = 0; n0 < N; n0 += NC) {
    const int nc = min(NC, N - n0);
    const float wt = tid < nc ? wk[n0 + tid] : 0.f;
    // a chunk whose weights are all zero adds nothing (the barrier also
    // ends the previous chunk's reads of shared memory)
    if (!__syncthreads_or(wt != 0.f)) continue;
    for (int idx = tid; idx < NC * D; idx += NT)
      s_x[idx] = idx < nc * D ? xs[(size_t)n0 * D + idx] : 0.f;
    if (tid < NC) {
      s_w[tid] = wt;
      float* zs = s_z + tid * ZW;
      zs[D] = 1.f;
      zs[D + 1] = tid < nc ? y[n0 + tid] : 0.f;
      zs[D + 2] = 0.f;
    }
    __syncthreads();

    // whiten the chunk: z[s][i] = sum_{j <= i} L[i][j] (x[s][j] - mu[j])
    for (int idx = tid; idx < NC * D; idx += NT) {
      const int s = idx / D, i = idx - s * D;
      const float* row = s_l + i * D;
      const float* xr = s_x + s * D;
      float zi = 0.f;
      for (int j = 0; j <= i; ++j) zi = fmaf(row[j], xr[j] - s_mu[j], zi);
      s_z[s * ZW + i] = zi;
    }
    __syncthreads();

    // the chunk's features for tiles a (weighted) and b
    for (int idx = tid; idx < NC * TF; idx += NT) {
      const int s = idx / TF, f = idx - s * TF;
      const float* zs = s_z + s * ZW;
      s_fa[s][f] = s_w[s] * (zs[s_fi[0][f]] * zs[s_fj[0][f]]);
      s_fb[s][f] = zs[s_fi[1][f]] * zs[s_fj[1][f]];
    }
    __syncthreads();

#pragma unroll 4
    for (int s = 0; s < NC; ++s) {
      const float4 av = *reinterpret_cast<const float4*>(&s_fa[s][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&s_fb[s][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], bc[c], acc[r][c]);
    }
  }

  // write out: rows f < F only; column F is the rhs
  float* gk = gram + (size_t)k * F * F;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int f = a * TF + ty * 4 + r;
    if (f >= F) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int g = b * TF + tx * 4 + c;
      if (g < F) {
        gk[(size_t)f * F + g] = acc[r][c];
        if (a != b) gk[(size_t)g * F + f] = acc[r][c];
      } else if (g == F) {
        rhs[(size_t)k * F + f] = acc[r][c];
      }
    }
  }
}

}  // namespace

// gram [K, F, F] and rhs [K, F] with F = D(D+1)/2 + D + 1, from inv_chols
// [K, D, D], means [K, D], w [K, N], y [N], x [N, D]; all float32,
// contiguous, on the current device.  1 <= D <= 45, K >= 1.
extern "C" int gmmvi_more_grams(const float* inv_chols, const float* means,
                                const float* w, const float* y,
                                const float* x, float* gram, float* rhs,
                                int K, int N, int D, void* stream) {
  if (K < 1 || D < 1 || D > MAX_D || N < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int F = D * (D + 1) / 2 + D + 1;
  const int ntiles = (F + 1 + TF - 1) / TF;  // F features and the y column
  const dim3 grid(ntiles * (ntiles + 1) / 2, K), block(NT);
  more_gram_kernel<<<grid, block, 0, st>>>(inv_chols, means, w, y, x, gram,
                                           rhs, N, D, F, ntiles);
  return (int)cudaGetLastError();
}
