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
// outweighs the bytes some hundred times.  Both run on the tensor cores as
// three TF32 products per product (3xTF32, tf32x3.cuh: float32 accuracy):
// B5 1.3e11 FLOP at stm300, ~0.26 ms at their 495 TFLOP/s, B6 with every
// responsibility nonzero 2.6e11, ~0.52 ms.  On the path B6 needs far less:
// the components lie far apart, so most (component, sample) pairs carry a
// responsibility that underflows to zero.
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
// B6, grads[n] = -sum_k (r_k(n) (x_n - mu_k))^T Lambda_k with r_k =
// exp(comp_k + log w_k - model) from B5's outputs and the symmetric
// Lambda_k = L_k^{-T} L_k^{-1} formed by the wrapper: the same engine, the
// samples along M, the output's columns d along N in tiles of 64, the
// reduction over e; Lambda_k's rows are its columns, so its slabs are
// K-major as they stand.  Pre-passes write r [K][sample tiles][64] with a
// flag per (component, 64-sample tile) "some r is nonzero", the samples
// as B5's A slabs, the means padded per 32-column slab, the TF32 halves
// of Lambda_k as 64-column x 32-step B slabs for the components with a
// live tile only, and the sample groups in order of decreasing work.  One
// block of two warpgroups owns a 128-sample x 64-column tile of grads (470
// blocks at stm300, two to an SM) and walks, through a ring of three
// bulk-copied stages, the 32-step slabs of only the components live on
// one of its two tiles: no copy is issued for a dead pair, and a
// warpgroup whose own tile is dead for the stage's component skips its
// products.  On the path the live pairs are few and uneven (820 live
// (component, tile) pairs of 7,520 on stm300's last inputs), so blocks are
// numbered longest first, and the card, which starts them in that order,
// packs the short ones behind (measured on an H100 at 700 W: on the
// stm300 path's last inputs 0.323 ms against 0.363 in index order, and
// two warpgroups and three stages beat four warpgroups and four stages,
// which copy for the union of four tiles' components).  A = r(n)(x_n - mu_k) is formed in registers, mu
// subtracted and r folded in before the split (B5's cancellation, and
// r's range of many decades); each slab's twelve wgmma start from zero and
// are added into a separate fp32 sum, in the same order on every call (no
// atomics, no reduction across blocks).
#include "tf32x3.cuh"

namespace {

constexpr float LOG_2PI = 1.8378770664093453f;
constexpr int MAX_D = 512;

constexpr int B5_GROUP = 4;  // warpgroups (64-sample tiles) per block
constexpr int B5_NT = 128 * B5_GROUP;
constexpr int B5_STAGES = 4;
constexpr int B6_GROUP = 2;  // warpgroups (64-sample tiles) per block
constexpr int B6_NT = 128 * B6_GROUP;
constexpr int B6_STAGES = 3;

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

struct B6Stage {
  float x[B6_GROUP][tf32x3::SLAB];  // A slabs: the block's samples, e0..
  float bh[tf32x3::SLAB];           // B slab of Lambda_k's TF32 halves:
  float bl[tf32x3::SLAB];           // steps e0.., columns d0..
  float r[B6_GROUP * tf32x3::TILE];  // r_k on the block's samples
  float mu[tf32x3::KS];              // mu_k on e0..
};

struct B6Layout {
  int DT, JS, NTp, G;
  size_t b_floats, x_floats, r_floats, mu_floats, bytes, smem;
};

B6Layout b6_layout(int K, int N, int D) {
  B6Layout l;
  l.DT = ceil_div(D, tf32x3::TILE);
  l.JS = ceil_div(D, tf32x3::KS);
  l.NTp = ceil_div(N > 0 ? N : 1, tf32x3::TILE * B6_GROUP) * B6_GROUP;
  l.G = l.NTp / B6_GROUP;
  l.b_floats = (size_t)K * l.DT * l.JS * tf32x3::SLAB;
  l.x_floats = (size_t)l.JS * l.NTp * tf32x3::SLAB;
  l.r_floats = (size_t)K * l.NTp * tf32x3::TILE;
  l.mu_floats = (size_t)K * l.JS * tf32x3::KS;
  l.bytes = (2 * l.b_floats + l.x_floats + l.r_floats + l.mu_floats) *
                sizeof(float) +
            ((size_t)K * l.NTp + l.G) * sizeof(int);
  l.smem = B6_STAGES * sizeof(B6Stage);
  return l;
}

// B6 pre-pass 1: r [K][NTp][64] (zeros past N, for a masked component and
// where the mixture is -inf), live[k][tile] = some r of the tile is
// nonzero, and (by the first tile's blocks) mu [K][JS * 32], zeros past D.
__global__ void grad_resp_kernel(const float* __restrict__ means,
                                 const float* __restrict__ logw,
                                 const float* __restrict__ comp,
                                 const float* __restrict__ model,
                                 float* __restrict__ rp,
                                 float* __restrict__ mup,
                                 int* __restrict__ live, int N, int D, int JS,
                                 int NTp) {
  const int tile = blockIdx.x, k = blockIdx.y, tid = threadIdx.x;
  const int n = tile * tf32x3::TILE + tid;
  const float lw = logw[k];
  float r = 0.f;
  if (n < N && lw > -INFINITY) {
    const float md = model[n];
    if (md > -INFINITY) r = expf(comp[(size_t)k * N + n] + lw - md);
  }
  rp[((size_t)k * NTp + tile) * tf32x3::TILE + tid] = r;
  const int any = __syncthreads_or(r != 0.f);
  if (tid == 0) live[(size_t)k * NTp + tile] = any;
  if (tile == 0)
    for (int j = tid; j < JS * tf32x3::KS; j += blockDim.x)
      mup[(size_t)k * JS * tf32x3::KS + j] =
          j < D ? means[(size_t)k * D + j] : 0.f;
}

// B6 pre-pass 2: bh, bl [K][DT][JS][slab image], the TF32 halves of
// Lambda_k as B slabs (columns d, steps e; zeros past D), for the
// components with a live tile only (the others are never read).
__global__ void grad_split_kernel(const float* __restrict__ lam,
                                  const int* __restrict__ live,
                                  float* __restrict__ bh,
                                  float* __restrict__ bl, int D, int DT,
                                  int JS, int NTp) {
  using tf32x3::KS;
  using tf32x3::TILE;
  const int dt = blockIdx.x / JS, js = blockIdx.x % JS, k = blockIdx.y;
  bool any = false;
  for (int t = threadIdx.x; t < NTp; t += blockDim.x)
    any |= live[(size_t)k * NTp + t] != 0;
  if (!__syncthreads_or(any)) return;
  const float* L = lam + (size_t)k * D * D;
  const size_t o = (((size_t)k * DT + dt) * JS + js) * tf32x3::SLAB;
  for (int idx = threadIdx.x; idx < tf32x3::SLAB; idx += blockDim.x) {
    // image position idx (writes in order) of column d, step e; Lambda is
    // symmetric, so (e, d) is read as (d, e), four steps contiguous
    const int d = dt * TILE + (idx / 4) % TILE;
    const int e = js * KS + (idx / (TILE * 4)) * 4 + (idx & 3);
    uint32_t hi, lo;
    tf32x3::split(d < D && e < D ? L[(size_t)d * D + e] : 0.f, hi, lo);
    bh[o + idx] = __uint_as_float(hi);
    bl[o + idx] = __uint_as_float(lo);
  }
}

// true where some flag of the block's GROUP tiles of group g is set
__device__ __forceinline__ bool group_live(const int* __restrict__ live,
                                           int k, int g, int NTp) {
  const int* f = live + (size_t)k * NTp + g * B6_GROUP;
  int any = 0;
#pragma unroll
  for (int t = 0; t < B6_GROUP; ++t) any |= f[t];
  return any != 0;
}

// B6 pre-pass 3: order[i], the sample groups by decreasing work (the
// components live on a group; ties by index), so that the main pass's
// blocks, which the card starts in index order, hand out the longest
// first.  Every block counts all G groups' work into shared memory, then
// ranks its own groups.
__global__ void grad_order_kernel(const int* __restrict__ live,
                                  int* __restrict__ order, int K, int NTp,
                                  int G) {
  extern __shared__ int work[];
  for (int h = threadIdx.x; h < G; h += blockDim.x) {
    int w = 0;
    for (int k = 0; k < K; ++k) w += group_live(live, k, h, NTp);
    work[h] = w;
  }
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int w = work[g];
  int rank = 0;
  for (int h = 0; h < G; ++h) {
    const int v = work[h];
    rank += v > w || (v == w && h < g);
  }
  order[rank] = g;
}

// B6 main pass: grads for one (256 samples, 64 columns) over the
// components live on the block's samples, on the tensor cores, each
// warpgroup 64 of the samples.
__global__ void __launch_bounds__(B6_NT, 1)
large_grad_kernel(const float* __restrict__ bh, const float* __restrict__ bl,
                  const float* __restrict__ xt, const float* __restrict__ rp,
                  const float* __restrict__ mup,
                  const int* __restrict__ live,
                  const int* __restrict__ order, float* __restrict__ grads,
                  int K, int N, int D, int DT, int JS, int NTp) {
  using tf32x3::KS;
  using tf32x3::SLAB;
  using tf32x3::SLAB_BYTES;
  using tf32x3::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  B6Stage* st = reinterpret_cast<B6Stage*>(smem);
  __shared__ __align__(8) uint64_t full[B6_STAGES];
  __shared__ int s_k[B6_STAGES];
  const int tid = threadIdx.x, wg = tid / 128;
  const int g = order[blockIdx.x / DT], dt = blockIdx.x % DT;
  const int tile = g * B6_GROUP + wg;  // this warpgroup's samples

  auto block_live = [&](int k) { return group_live(live, k, g, NTp); };
  int nk = 0;  // the components the block visits
  for (int base = 0; base < K; base += B6_NT)
    nk += __syncthreads_count(base + tid < K && block_live(base + tid));
  const int count = nk * JS;

  if (tid == 0) {
    for (int s = 0; s < B6_STAGES; ++s) tf32x3::mbar_init(&full[s], 1);
    tf32x3::mbar_init_fence();
  }
  __syncthreads();

  // the producer (thread 0): its cursor over (live component, slab)
  int pk = 0, pj = 0;
  auto issue = [&](int stage) {
    if (pj == 0)
      while (pk < K && !block_live(pk)) ++pk;
    if (pk >= K) return;
    B6Stage& s = st[stage];
    s_k[stage] = pk;
    tf32x3::mbar_expect(&full[stage], (B6_GROUP + 2) * SLAB_BYTES +
                                          (B6_GROUP * TILE + KS) * 4);
    tf32x3::bulk_copy(s.x[0],
                      xt + ((size_t)pj * NTp + g * B6_GROUP) * SLAB,
                      B6_GROUP * SLAB_BYTES, &full[stage]);
    const size_t o = (((size_t)pk * DT + dt) * JS + pj) * SLAB;
    tf32x3::bulk_copy(s.bh, bh + o, SLAB_BYTES, &full[stage]);
    tf32x3::bulk_copy(s.bl, bl + o, SLAB_BYTES, &full[stage]);
    tf32x3::bulk_copy(s.r, rp + ((size_t)pk * NTp + g * B6_GROUP) * TILE,
                      B6_GROUP * TILE * 4, &full[stage]);
    tf32x3::bulk_copy(s.mu, mup + ((size_t)pk * JS + pj) * KS, KS * 4,
                      &full[stage]);
    if (++pj == JS) {
      pj = 0;
      ++pk;
    }
  };

  const int lane = tid & 31, r0 = 16 * ((tid >> 5) & 3) + (lane >> 2);
  float tot[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = 0.f;
  if (tid == 0)
    for (int s = 0; s < B6_STAGES - 1; ++s) issue(s);
  for (int s = 0; s < count; ++s) {
    // every thread is done with the previous slab's stage: refill it
    __syncthreads();
    if (tid == 0) {
      tf32x3::fence_async_smem();
      issue((s + B6_STAGES - 1) % B6_STAGES);
    }
    const int stage = s % B6_STAGES;
    tf32x3::mbar_wait(&full[stage], (s / B6_STAGES) & 1);
    const B6Stage& cur = st[stage];
    // uniform over the warpgroup
    if (!live[(size_t)s_k[stage] * NTp + tile]) continue;
    const float* mu = cur.mu;
    float av[KS / 8][4];
    tf32x3::load_a(cur.x[wg], av, [&](float v, int c) { return v - mu[c]; });
    // rows r0 and r0 + 8 of the fragment: fold in their r
    const float ra = cur.r[wg * TILE + r0], rb = cur.r[wg * TILE + r0 + 8];
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
      av[j][0] *= ra;
      av[j][1] *= rb;
      av[j][2] *= ra;
      av[j][3] *= rb;
    }
    tf32x3::slab_product(acc, av, cur.bh, cur.bl);
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[i] += acc[i];
  }

  // d[4c + 0..1] at row r0, d[4c + 2..3] at row r0 + 8, columns 8c + 2 tig
  const int d0 = dt * TILE;
#pragma unroll
  for (int c = 0; c < TILE / 8; ++c) {
    const int d = d0 + 8 * c + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = tile * TILE + r0 + 8 * h;
      if (n >= N) continue;
      if (d < D) grads[(size_t)n * D + d] = -tot[4 * c + 2 * h];
      if (d + 1 < D) grads[(size_t)n * D + d + 1] = -tot[4 * c + 2 * h + 1];
    }
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

// Bytes of scratch gmmvi_density_grads_large needs for these sizes.
extern "C" size_t gmmvi_density_grads_large_workspace(int K, int N, int D) {
  return b6_layout(K, N, D).bytes;
}

// grads [N, D] from lam [K, D, D] (precisions, symmetric up to rounding:
// row d is read as column d), means [K, D],
// logw [K], comp [K, N] and model [N] (B5's outputs) and x [N, D]; all
// float32, contiguous, on the current device; ws of
// gmmvi_density_grads_large_workspace bytes (16-byte aligned).
// 1 <= D <= 512, 1 <= K <= 65,535, N <= 7,438,336 (the order pre-pass
// holds one count per 128-sample group in 227 KB of shared memory).
extern "C" int gmmvi_density_grads_large(const float* lam, const float* means,
                                         const float* logw, const float* comp,
                                         const float* model, const float* x,
                                         float* grads, void* ws, int K, int N,
                                         int D, void* stream) {
  // K rides the pre-passes' grid y axis (at most 65,535 blocks)
  if (K < 1 || K > 65535 || D < 1 || D > MAX_D || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const B6Layout l = b6_layout(K, N, D);
  float* bh = static_cast<float*>(ws);
  float* bl = bh + l.b_floats;
  float* xt = bl + l.b_floats;
  float* rp = xt + l.x_floats;
  float* mup = rp + l.r_floats;
  int* live = reinterpret_cast<int*>(mup + l.mu_floats);
  int* order = live + (size_t)K * l.NTp;
  grad_resp_kernel<<<dim3(l.NTp, K), tf32x3::TILE, 0, st>>>(
      means, logw, comp, model, rp, mup, live, N, D, l.JS, l.NTp);
  large_xtiles_kernel<<<dim3(l.NTp, l.JS), 256, 0, st>>>(x, xt, N, D, l.NTp);
  grad_split_kernel<<<dim3(l.DT * l.JS, K), 256, 0, st>>>(
      lam, live, bh, bl, D, l.DT, l.JS, l.NTp);
  const int order_smem = l.G * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      grad_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      order_smem);
  if (err != cudaSuccess) return (int)err;
  grad_order_kernel<<<ceil_div(l.G, 128), 128, order_smem, st>>>(
      live, order, K, l.NTp, l.G);
  err = cudaFuncSetAttribute(
      large_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  large_grad_kernel<<<l.G * l.DT, B6_NT, l.smem, st>>>(
      bh, bl, xt, rp, mup, live, order, grads, K, N, D, l.DT, l.JS, l.NTp);
  return (int)cudaGetLastError();
}
