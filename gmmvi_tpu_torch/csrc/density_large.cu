// K-tiled mixture density passes for large D on Hopper (sm_90a): kernels B5
// (component densities and the mixture logsumexp) and B6 (the analytic
// mixture gradient).
//
// Replaces the TPU kernels gmmvi_tpu/ops/pallas_density_large.py
// `_density_kernel` (B5) and `_grad_kernel` (B6).  Python wrappers and plain
// versions: gmmvi_tpu_torch/ops/density_large.py.
//
// What bounds them on this card: arithmetic.  At the stm300 shapes (K = 40,
// N = 12,000, D = 300) B5 whitens every sample against every factor,
// K N D(D+1)/2 = 2.2e10 multiply-adds, and B6 applies every precision,
// K N D^2 = 4.3e10, against ~15 MB of factors and samples: the arithmetic
// outweighs the bytes some hundred times.  B5 runs on the tensor cores as
// three TF32 products per product (3xTF32, tf32x3.cuh: float32 accuracy),
// 1.3e11 FLOP at stm300, ~0.26 ms at their 495 TFLOP/s; B6 still on the
// CUDA cores (fp32 FMA, simt_tile.cuh).
//
// Why the small-D design (density.cu: one sample per thread, the factors
// resident in shared memory) does not carry over: at D = 300 one factor is
// 360 KB, more than a block's 227 KB of shared memory, and a thread cannot
// keep a 300-vector in registers.  So both passes are batched GEMMs with
// fused epilogues.
//
// B5, Y^T = (X - mu_k) L_k^T: the samples along wgmma's M axis, the
// factor's rows i along N in column tiles of 64, the reduction over j, the
// factor's columns, which are contiguous in its rows (K-major, as TF32
// wgmma needs).  Pre-passes write both operands slab by slab in the image
// a stage of shared memory holds (tf32x3.cuh): the factors split into
// their TF32 halves as 64-row x 32-column B slabs (zeros above the
// diagonal and past D), the samples as 64 x 32 A slabs.  One block of four
// warpgroups takes one component and 256 samples, 64 per warpgroup
// (1,880 blocks at stm300); the four share each factor slab.  For the
// column tile of rows i0..i0+63 the block visits the 32-column slabs at or
// left of the diagonal block only (the factor is lower triangular: about
// half the products), through a ring of four stages, each filled by bulk
// copies (48 KB) that one thread issues on an mbarrier, so that the next
// three slabs' copies run under this one's products.  A = x - mu_k is
// formed in registers, mu subtracted before the split (the TPU kernel's
// bias fold W x - b cancels at |mu| ~ 100); each slab's twelve wgmma start
// from zero and are added into a separate fp32 sum.  When a column tile is
// done its rows are squared and summed in registers into each sample's
// Mahalanobis sum: no Y reaches memory; the block writes comp[k, n].  The
// TPU kernel carries the mixture logsumexp over its sequential K axis;
// here blocks of one sample tile run in parallel on other SMs, so a second
// small kernel takes the logsumexp over comp's K rows (one thread per
// sample, online max and rescaled sum), for one extra read of comp (K N
// floats, ~2 MB).  In the background mode rows with a -inf log weight are
// skipped outright (neither split nor whitened: their blocks return at
// once), so the count-weighted background over U = 160 ring rows of which
// about half are live costs only the live half; comp is then scratch that
// the caller never sees.
//
// B6, grads[n] = -sum_k r_k(n) Lambda_k (x_n - mu_k) with r_k = exp(comp_k
// + log w_k - model) from B5's outputs and Lambda_k = L_k^{-T} L_k^{-1}
// formed by the wrapper: one block of 64 threads per (64-row slab of D,
// 64-sample tile) accumulates over every component and every 32-row slab
// of Lambda_k, the operand r_k(n) (x_n - mu_k) built while staging, with
// the 8 x 8 register micro-tiles of simt_tile.cuh.  No reduction crosses
// blocks.  A component whose responsibilities underflow to zero on the
// whole tile is skipped (at stm300 the components lie far apart, so most
// are).
#include <math.h>

#include "simt_tile.cuh"
#include "tf32x3.cuh"

namespace {

using simt::NT;
using simt::S;
using simt::T;
using simt::TK;

constexpr float LOG_2PI = 1.8378770664093453f;
constexpr int MAX_D = 512;

constexpr int B5_GROUP = 4;  // warpgroups (64-sample tiles) per block
constexpr int B5_NT = 128 * B5_GROUP;
constexpr int B5_STAGES = 4;

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

struct B5Stage {
  float x[B5_GROUP][tf32x3::SLAB];  // A slabs: samples, columns j0..
  float bh[tf32x3::SLAB];           // B slab of the factor's TF32 halves:
  float bl[tf32x3::SLAB];           // columns j0.. (steps), rows i0..
};

// B5 pre-pass 1: lh, ll [K][IT][JS][slab image] (IT = D / 64 and JS = D /
// 32 rounded up), the TF32 halves of each factor's lower triangle as B
// slabs (rows i, steps j), zeros above the diagonal and past D; the slabs
// right of the diagonal block (never read) and, in the background mode,
// the rows with a -inf log weight are left unwritten.
__global__ void large_split_kernel(const float* __restrict__ inv_chols,
                                   const float* __restrict__ logw,
                                   float* __restrict__ lh,
                                   float* __restrict__ ll, int D, int IT,
                                   int JS, int skip_masked) {
  using tf32x3::KS;
  using tf32x3::TILE;
  const int it = blockIdx.x / JS, js = blockIdx.x % JS, k = blockIdx.y;
  if (js * KS > it * TILE + TILE - 1) return;
  if (skip_masked && !(logw[k] > -INFINITY)) return;
  const float* L = inv_chols + (size_t)k * D * D;
  const size_t o = (((size_t)k * IT + it) * JS + js) * tf32x3::SLAB;
  for (int idx = threadIdx.x; idx < tf32x3::SLAB; idx += blockDim.x) {
    // image position idx (writes in order) of row i, column j
    const int i = it * TILE + (idx / 4) % TILE;
    const int j = js * KS + (idx / (TILE * 4)) * 4 + (idx & 3);
    uint32_t hi, lo;
    tf32x3::split(i < D && j <= i ? L[(size_t)i * D + j] : 0.f, hi, lo);
    lh[o + idx] = __uint_as_float(hi);
    ll[o + idx] = __uint_as_float(lo);
  }
}

// B5 pre-pass 2: xt [JS][NTp][slab image], the samples as A slabs (64
// samples, 32 columns), zeros past N and D; NTp sample tiles, a multiple
// of B5_GROUP.
__global__ void large_xtiles_kernel(const float* __restrict__ x,
                                    float* __restrict__ xt, int N, int D,
                                    int NTp) {
  using tf32x3::KS;
  using tf32x3::TILE;
  const int nt = blockIdx.x, js = blockIdx.y;
  const size_t o = ((size_t)js * NTp + nt) * tf32x3::SLAB;
  for (int idx = threadIdx.x; idx < tf32x3::SLAB; idx += blockDim.x) {
    const int r = idx / KS, cs = idx % KS;
    const int n = nt * TILE + r;
    const int j = js * KS + ((((cs >> 2) ^ (r & 7))) << 2) + (cs & 3);
    xt[o + idx] = n < N && j < D ? x[(size_t)n * D + j] : 0.f;
  }
}

// B5 pass 1: comp[k, n] for one (component, 256 samples) on the tensor
// cores, each warpgroup 64 of the samples.
__global__ void __launch_bounds__(B5_NT, 1)
large_comp_kernel(const float* __restrict__ means,
                  const float* __restrict__ lh, const float* __restrict__ ll,
                  const float* __restrict__ logw,
                  const float* __restrict__ logdets,
                  const float* __restrict__ xt, float* __restrict__ comp,
                  int N, int D, int IT, int JS, int NTp, int skip_masked) {
  using tf32x3::KS;
  using tf32x3::SLAB;
  using tf32x3::SLAB_BYTES;
  using tf32x3::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  B5Stage* st = reinterpret_cast<B5Stage*>(smem);
  float* s_mu = reinterpret_cast<float*>(st + B5_STAGES);  // [JS * KS]
  __shared__ __align__(8) uint64_t full[B5_STAGES];
  const int k = blockIdx.y;
  // uniform over the block: a masked row of the background is not needed
  if (skip_masked && !(logw[k] > -INFINITY)) return;
  const int tid = threadIdx.x, wg = tid / 128;
  for (int j = tid; j < JS * KS; j += B5_NT)
    s_mu[j] = j < D ? means[(size_t)k * D + j] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < B5_STAGES; ++s) tf32x3::mbar_init(&full[s], 1);
    tf32x3::mbar_init_fence();
  }
  __syncthreads();

  // the column tiles i0 = 64 t and, for each, the 32-column slabs at or
  // left of its diagonal block
  auto slabs = [&](int t) { return ceil_div(min(TILE * (t + 1), D), KS); };
  int pt = 0, pj = 0;  // the producer's (thread 0's) cursor
  auto issue = [&](int stage) {
    if (pt >= IT) return;
    B5Stage& s = st[stage];
    tf32x3::mbar_expect(&full[stage], (B5_GROUP + 2) * SLAB_BYTES);
    tf32x3::bulk_copy(
        s.x[0], xt + ((size_t)pj * NTp + blockIdx.x * B5_GROUP) * SLAB,
        B5_GROUP * SLAB_BYTES, &full[stage]);
    const size_t o = (((size_t)k * IT + pt) * JS + pj) * SLAB;
    tf32x3::bulk_copy(s.bh, lh + o, SLAB_BYTES, &full[stage]);
    tf32x3::bulk_copy(s.bl, ll + o, SLAB_BYTES, &full[stage]);
    if (++pj == slabs(pt)) {
      ++pt;
      pj = 0;
    }
  };

  float tot[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = 0.f;
  float maha0 = 0.f, maha1 = 0.f;  // rows gid and gid + 8 of this warp
  if (tid == 0)
    for (int s = 0; s < B5_STAGES - 1; ++s) issue(s);
  int s = 0;
  for (int t = 0; t < IT; ++t) {
    const int nj = slabs(t);
    for (int j = 0; j < nj; ++j, ++s) {
      // every thread is done with the previous slab's stage: refill it
      __syncthreads();
      if (tid == 0) {
        tf32x3::fence_async_smem();
        issue((s + B5_STAGES - 1) % B5_STAGES);
      }
      const int stage = s % B5_STAGES;
      tf32x3::mbar_wait(&full[stage], (s / B5_STAGES) & 1);
      const B5Stage& cur = st[stage];
      const float* mu = s_mu + j * KS;
      float av[KS / 8][4];
      tf32x3::load_a(cur.x[wg], av, [&](float v, int c) { return v - mu[c]; });
      tf32x3::slab_product(acc, av, cur.bh, cur.bl);
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[i] += acc[i];
    }
    // rows past D were staged as zeros and add nothing
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c) {
      maha0 = fmaf(tot[4 * c], tot[4 * c], maha0);
      maha0 = fmaf(tot[4 * c + 1], tot[4 * c + 1], maha0);
      maha1 = fmaf(tot[4 * c + 2], tot[4 * c + 2], maha1);
      maha1 = fmaf(tot[4 * c + 3], tot[4 * c + 3], maha1);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[i] = 0.f;
  }

  // the four lanes of a row hold its columns 2 tig + {0, 1} mod 8
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    maha0 += __shfl_xor_sync(0xffffffffu, maha0, m);
    maha1 += __shfl_xor_sync(0xffffffffu, maha1, m);
  }
  const int lane = tid & 31;
  if ((lane & 3) == 0) {
    const float c0 = -logdets[k] - 0.5f * (float)D * LOG_2PI;
    const int n = (blockIdx.x * B5_GROUP + wg) * TILE +
                  16 * ((tid >> 5) & 3) + (lane >> 2);
    if (n < N) comp[(size_t)k * N + n] = -0.5f * maha0 + c0;
    if (n + 8 < N) comp[(size_t)k * N + n + 8] = -0.5f * maha1 + c0;
  }
}

struct B5Layout {
  int IT, JS, NTp;
  size_t l_floats, x_floats, bytes, smem;
};

B5Layout b5_layout(int K, int N, int D) {
  B5Layout l;
  l.IT = ceil_div(D, tf32x3::TILE);
  l.JS = ceil_div(D, tf32x3::KS);
  l.NTp = ceil_div(N > 0 ? N : 1, tf32x3::TILE * B5_GROUP) * B5_GROUP;
  l.l_floats = (size_t)K * l.IT * l.JS * tf32x3::SLAB;
  l.x_floats = (size_t)l.JS * l.NTp * tf32x3::SLAB;
  l.bytes = (2 * l.l_floats + l.x_floats) * sizeof(float);
  l.smem = B5_STAGES * sizeof(B5Stage) + l.JS * tf32x3::KS * sizeof(float);
  return l;
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

// Bytes of scratch gmmvi_densities_large needs for these sizes.
extern "C" size_t gmmvi_densities_large_workspace(int K, int N, int D) {
  return b5_layout(K, N, D).bytes;
}

// comp [K, N] (scratch in the background mode, where only the rows with a
// finite log weight are written) and model [N] from means [K, D], lower
// triangular inv_chols [K, D, D] (the upper triangle is not read), logw [K],
// logdets [K] and x [N, D]; all float32, contiguous, on the current device;
// ws of gmmvi_densities_large_workspace bytes (16-byte aligned).
// 1 <= D <= 512, 1 <= K <= 65,535.
extern "C" int gmmvi_densities_large(const float* means,
                                     const float* inv_chols,
                                     const float* logw, const float* logdets,
                                     const float* x, float* comp,
                                     float* model, void* ws, int K, int N,
                                     int D, int skip_masked, void* stream) {
  // K rides the grid's y axis (at most 65,535 blocks)
  if (K < 1 || K > 65535 || D < 1 || D > MAX_D || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const B5Layout l = b5_layout(K, N, D);
  float* lh = static_cast<float*>(ws);
  float* ll = lh + l.l_floats;
  float* xt = ll + l.l_floats;
  large_split_kernel<<<dim3(l.IT * l.JS, K), 256, 0, st>>>(
      inv_chols, logw, lh, ll, D, l.IT, l.JS, skip_masked);
  large_xtiles_kernel<<<dim3(l.NTp, l.JS), 256, 0, st>>>(x, xt, N, D, l.NTp);
  cudaError_t err = cudaFuncSetAttribute(
      large_comp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  large_comp_kernel<<<dim3(l.NTp / B5_GROUP, K), B5_NT, l.smem, st>>>(
      means, lh, ll, logw, logdets, xt, comp, N, D, l.IT, l.JS, l.NTp,
      skip_masked);
  err = cudaGetLastError();
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
