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
// What bounds it on this card: the tensor cores, on the samples that carry
// weight.  The weights are self-normalized importance weights, and exp
// underflows most (component, sample) pairs of a reuse window to exact
// zeros, scattered through it (at the reuse path's shape, K = 48, N =
// 28,800, D = 20, about 0.4 M of 1.4 M pairs are nonzero).  Over those the
// Gram is ~11 GFMA, taken as three TF32 products each (3xTF32, tf32x3.cuh:
// float32 accuracy, which the ridge of 1e-12 needs, since the Gram's
// rounding reaches the solve).
//
// Design.  Like the TPU kernel, only the [F, F] Gram and the rhs reach
// device memory: the [N, F] design matrix never does.
//
// 1. A pre-pass lists, for each component, the indices n with w[k, n] != 0
//    in increasing n, and their count (warp ballots and a block scan, no
//    atomics: the order is fixed).  Nothing later touches a zero weight.
// 2. A one-block pass lays the live slabs of all components end to end
//    (slabs of KS = 32 live samples; start[k] = the slabs before component
//    k) and the main kernel cuts that line into B equal ranges, one per
//    block: the components' live counts differ by orders of magnitude (a
//    broad component can keep weight on most of the window, a narrow one on
//    a few samples), so fixed shares per component would leave the card
//    waiting on the largest.  The features are extended by one column, y
//    (the rhs is then the Gram's last column), padded to T tiles of 64, and
//    the upper triangle of tiles, P = T(T+1)/2 tile pairs (a <= b), is
//    dealt out WG tile pairs per block, one per warpgroup.  A block walks
//    its range component by component (usually one or two) in slabs: the x
//    rows (by index, the indices loaded two slabs ahead), weights and
//    outputs are gathered into a ring of shared-memory stages
//    with cp.async (16-byte pieces where D allows), the copies of the next
//    slabs running under this one; the block whitens the slab once in fp32
//    FMA (D(D+1)/2 FMAs a sample, small beside the Gram); each warpgroup
//    writes its column tile's unweighted features of the slab, split into
//    TF32 halves, in the K-major image that wgmma reads (tf32x3.cuh), and
//    forms its row tile's weighted features (the weight folded in before
//    the split) in registers, in the A fragment.  Each slab's twelve wgmma
//    start from zero and are added into a separate fp32 sum.  At the end of
//    each component's part of its range a block writes its tile pairs'
//    partial sums to scratch slot (block + component), unique since the
//    ranges are contiguous.
// 3. A last pass sums, per component and tile pair, the partial sums of
//    the blocks whose ranges meet the component, in block order, and writes
//    the tile and its mirror image (through shared memory, both coalesced);
//    the rhs comes from the y column.  Two calls on the same inputs give
//    the same bits; a component with no weight gets an exactly-zero Gram.
#include "tf32x3.cuh"

namespace {

using tf32x3::KS;
using tf32x3::SLAB;
using tf32x3::TILE;

constexpr int MAX_D = 45;
constexpr int WG = 2;             // warpgroups (tile pairs) per block
constexpr int NT = 128 * WG;
constexpr int STAGES = 3;         // gather ring
constexpr int XW = 48;            // floats of a gathered x row (>= MAX_D)
constexpr int ZW = MAX_D + 4;     // z row: z_0..z_{D-1}, then 1, y, 0
constexpr int COMPACT_NT = 1024;
constexpr int SCHED_NT = 1024;
constexpr int COMBINE_NT = 256;
constexpr int NUM_SMS = 132;      // H100 SXM: two blocks on each SM

struct Smem {
  float b[WG][2][SLAB];           // each warpgroup's B image: hi, lo
  float x[STAGES][KS][XW];        // gathered x rows
  float w[STAGES][KS];
  float y[STAGES][KS];
  float d[MAX_D][KS];             // x - mu, transposed
  float z[KS][ZW];                // the whitened slab, extended
  float l[MAX_D * (MAX_D + 1)];   // L_k^{-1}, rows at an odd stride
  float mu[MAX_D];
  int idx[STAGES][KS];            // sample indices of the staged slabs
};

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

// tile pair p -> (a, b), a <= b, of the upper triangle of T x T tiles
__device__ __forceinline__ void tile_pair(int p, int T, int& a, int& b) {
  a = 0;
  while (p >= T - a) {
    p -= T - a;
    ++a;
  }
  b = a + p;
}

// bytes (16 or 4) from global src to shared dst, zero-filled where
// src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tf32x3::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tf32x3::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pre-pass: idx[k][0..cnt[k]) = the n with w[k, n] != 0, increasing.
__global__ void __launch_bounds__(COMPACT_NT)
more_compact_kernel(const float* __restrict__ w, int* __restrict__ idx,
                    int* __restrict__ cnt, int N) {
  __shared__ int s_off[32];
  __shared__ int s_total;
  const int k = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* wk = w + (size_t)k * N;
  int* ik = idx + (size_t)k * N;
  int base = 0;
  for (int n0 = 0; n0 < N; n0 += COMPACT_NT) {
    const int n = n0 + tid;
    const bool live = n < N && wk[n] != 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_off[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the warps' counts
      const int v = s_off[lane];
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      s_off[lane] = incl - v;
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
    if (live) ik[base + s_off[warp] + __popc(bal & ((1u << lane) - 1u))] = n;
    base += s_total;
    __syncthreads();
  }
  if (tid == 0) cnt[k] = base;
}


// Pre-pass 2: start[k] = the live slabs of the components before k;
// start[K] = all of them.
__global__ void __launch_bounds__(SCHED_NT)
more_schedule_kernel(const int* __restrict__ cnt, int* __restrict__ start,
                     int K) {
  __shared__ int s_sum[SCHED_NT];
  const int tid = threadIdx.x;
  const int per = (K + SCHED_NT - 1) / SCHED_NT;
  const int k0 = min(K, tid * per), k1 = min(K, k0 + per);
  int sum = 0;
  for (int k = k0; k < k1; ++k) sum += (cnt[k] + KS - 1) / KS;
  s_sum[tid] = sum;
  __syncthreads();
  for (int o = 1; o < SCHED_NT; o <<= 1) {  // inclusive scan
    const int v = tid >= o ? s_sum[tid - o] : 0;
    __syncthreads();
    s_sum[tid] += v;
    __syncthreads();
  }
  int run = s_sum[tid] - sum;
  for (int k = k0; k < k1; ++k) {
    start[k] = run;
    run += (cnt[k] + KS - 1) / KS;
  }
  if (tid == SCHED_NT - 1) start[K] = s_sum[tid];
}

// the slab range [g0, g1) of block b of B over `total` slabs
__device__ __forceinline__ void block_range(int b, int B, int total, int& g0,
                                            int& g1) {
  g0 = (int)((long long)total * b / B);
  g1 = (int)((long long)total * (b + 1) / B);
}

// Main pass: block (blockIdx.x of B, tile-pair group blockIdx.y); part
// [B + K][P][64][64].
__global__ void __launch_bounds__(NT, 2)
more_mma_kernel(const float* __restrict__ inv_chols,
                const float* __restrict__ means, const float* __restrict__ w,
                const float* __restrict__ y, const float* __restrict__ xs,
                const int* __restrict__ idx, const int* __restrict__ cnt,
                const int* __restrict__ start, float* __restrict__ part,
                int K, int N, int D, int T, int P, int B) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int blk = blockIdx.x;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int p = blockIdx.y * WG + wg;  // this warpgroup's tile pair
  const bool active = p < P;
  int a = 0, b = 0;
  if (active) tile_pair(p, T, a, b);

  // this thread's two rows of the A fragment (features of tile a) and two
  // columns of its B image (features of tile b), as z indices
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int r0 = 16 * warp + (lane >> 2), tig = lane & 3;
  int ai0, aj0, ai1, aj1, bi0, bj0, bi1, bj1;
  feature_pair(a * TILE + r0, D, ai0, aj0);
  feature_pair(a * TILE + r0 + 8, D, ai1, aj1);
  const int bc0 = (wtid >> 2) & (TILE - 1);  // image columns bc0, bc0 + 32
  feature_pair(b * TILE + bc0, D, bi0, bj0);
  feature_pair(b * TILE + bc0 + 32, D, bi1, bj1);

  int g0, g1;
  block_range(blk, B, start[K], g0, g1);
  if (g0 >= g1) return;
  // the component of slab g0: the last k with start[k] <= g0 (it is not
  // empty, since start[k + 1] > g0)
  int lo = 0, hi = K - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= g0)
      lo = mid;
    else
      hi = mid - 1;
  }
  int k = lo;

  const bool vec = (D & 3) == 0;
  const int ls = D | 1;  // row stride of L: rows in distinct banks
  float tot[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = 0.f;

  for (int g = g0; g < g1; ++k) {
    while (start[k + 1] <= g) ++k;  // components without weight
    const int ls0 = g - start[k], ls1 = min(g1, start[k + 1]) - start[k];
    g = ls1 + start[k];
    const int count = cnt[k];
    const int* ik = idx + (size_t)k * N;
    const float* wk = w + (size_t)k * N;

    // gather slab ls0 + rel into stage rel % STAGES (if it is in the
    // range), its indices already in sm.idx; every thread commits one
    // group, empty or not, so the counts stay in step
    auto issue = [&](int rel) {
      const int stage = rel % STAGES;
      if (ls0 + rel < ls1) {
        const int* si = sm.idx[stage];
        if (vec) {
          const int q = D >> 2;
          for (int e = tid; e < KS * q; e += NT) {
            const int s = e / q, c = e - s * q, n = si[s];
            cp_async16(&sm.x[stage][s][4 * c],
                       xs + (size_t)max(n, 0) * D + 4 * c, n >= 0 ? 16 : 0);
          }
        } else {
          for (int e = tid; e < KS * D; e += NT) {
            const int s = e / D, c = e - s * D, n = si[s];
            cp_async4(&sm.x[stage][s][c], xs + (size_t)max(n, 0) * D + c,
                      n >= 0 ? 4 : 0);
          }
        }
        if (tid < KS) {
          const int n = si[tid];
          cp_async4(&sm.w[stage][tid], wk + max(n, 0), n >= 0 ? 4 : 0);
          cp_async4(&sm.y[stage][tid], y + max(n, 0), n >= 0 ? 4 : 0);
        }
      }
      cp_async_commit();
    };
    // the index of sample tid of slab ls0 + rel, -1 past the live list
    auto index = [&](int rel) {
      const int n = (ls0 + rel) * KS + tid;
      return ls0 + rel < ls1 && n < count ? ik[n] : -1;
    };

    // every thread is done with the previous component's shared memory
    __syncthreads();
    for (int e = tid; e < D * D; e += NT)
      sm.l[e / D * ls + e % D] = inv_chols[(size_t)k * D * D + e];
    for (int e = tid; e < D; e += NT) sm.mu[e] = means[(size_t)k * D + e];
    if (tid < KS)
      for (int s = 0; s < STAGES; ++s) sm.idx[s][tid] = index(s);
    // the indices of slab it + STAGES, loaded an iteration before they are
    // stored (in the slot of slab it, whose gather is issued) and two
    // before they are used
    int pending = tid < KS ? index(STAGES) : -1;
    __syncthreads();
    for (int s = 0; s < STAGES - 1; ++s) issue(s);

    for (int it = 0; ls0 + it < ls1; ++it) {
      const int stage = it % STAGES;
      cp_async_wait<STAGES - 2>();
      // the slab has landed, and every thread is done with the previous one
      __syncthreads();
      issue(it + STAGES - 1);
      if (tid < KS) {
        sm.idx[stage][tid] = pending;
        pending = index(it + STAGES + 1);
      }

      // whiten: z[s][i] = sum_{j <= i} L[i][j] (x[s][j] - mu[j]), a warp
      // taking one row i for the slab's 32 samples (padded samples have
      // x = 0, w = 0, y = 0)
      const float(*xr)[XW] = sm.x[stage];
      for (int e = tid; e < KS * D; e += NT) {
        const int j = e / KS, s = e - j * KS;
        sm.d[j][s] = xr[s][j] - sm.mu[j];
      }
      __syncthreads();
      for (int e = tid; e < KS * D; e += NT) {
        const int i = e / KS, s = e - i * KS;
        const float* row = sm.l + i * ls;
        float zi = 0.f;
        for (int j = 0; j <= i; ++j) zi = fmaf(row[j], sm.d[j][s], zi);
        sm.z[s][i] = zi;
      }
      if (tid < KS) {
        sm.z[tid][D] = 1.f;
        sm.z[tid][D + 1] = sm.y[stage][tid];
        sm.z[tid][D + 2] = 0.f;
      }
      __syncthreads();

      if (active) {
        // B: tile b's features of the slab, split, in image order: entry
        // (step c, column r) at ((c / 4) * 64 + r) * 4 + c % 4
        float* bh = sm.b[wg][0];
        float* bl = sm.b[wg][1];
#pragma unroll
        for (int m = 0; m < SLAB / 128; ++m) {
          const int e = wtid + 128 * m;
          const int c = (m >> 1) * 4 + (wtid & 3);
          const float v = (m & 1) ? sm.z[c][bi1] * sm.z[c][bj1]
                                  : sm.z[c][bi0] * sm.z[c][bj0];
          uint32_t hi, lo;
          tf32x3::split(v, hi, lo);
          bh[e] = __uint_as_float(hi);
          bl[e] = __uint_as_float(lo);
        }
        // the image is read by wgmma through the async proxy
        tf32x3::fence_async_smem();
      }
      __syncthreads();

      if (active) {
        // A: tile a's weighted features in the fragment of mma.m16n8k8
        const float* ws = sm.w[stage];
        float av[KS / 8][4];
#pragma unroll
        for (int j = 0; j < KS / 8; ++j) {
          const int c0 = 8 * j + tig, c1 = c0 + 4;
          av[j][0] = ws[c0] * (sm.z[c0][ai0] * sm.z[c0][aj0]);
          av[j][1] = ws[c0] * (sm.z[c0][ai1] * sm.z[c0][aj1]);
          av[j][2] = ws[c1] * (sm.z[c1][ai0] * sm.z[c1][aj0]);
          av[j][3] = ws[c1] * (sm.z[c1][ai1] * sm.z[c1][aj1]);
        }
        tf32x3::slab_product(acc, av, sm.b[wg][0], sm.b[wg][1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) tot[i] += acc[i];
      }
    }

    if (active) {  // this component's part of the range
      float* out = part + ((size_t)(blk + k) * P + p) * (TILE * TILE);
#pragma unroll
      for (int c = 0; c < TILE / 8; ++c) {
        const int col = 8 * c + 2 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          *reinterpret_cast<float2*>(out + row * TILE + col) =
              make_float2(tot[4 * c + 2 * h], tot[4 * c + 2 * h + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[i] = 0.f;
    }
  }
}

// Last pass: tile pair blockIdx.x of component blockIdx.y, summed over the
// blocks whose ranges meet the component, in block order; written as
// gram[k] (the tile and its mirror) and, from the y column, rhs[k].
__global__ void __launch_bounds__(COMBINE_NT)
more_combine_kernel(const float* __restrict__ part,
                    const int* __restrict__ start, float* __restrict__ gram,
                    float* __restrict__ rhs, int F, int T, int P, int B) {
  __shared__ float s[TILE][TILE + 1];
  const int p = blockIdx.x, k = blockIdx.y, K = gridDim.y;
  const int tid = threadIdx.x;
  int a, b;
  tile_pair(p, T, a, b);
  __shared__ int s_blocks[2 * NUM_SMS], s_nblocks;
  const int total = start[K], s0 = start[k], s1 = start[k + 1];
  if (tid == 0) {  // the blocks that processed component k, in order
    int nb = 0;
    for (int bb = 0; bb < B && s1 > s0; ++bb) {
      int g0, g1;
      block_range(bb, B, total, g0, g1);
      if (g0 < g1 && g0 < s1 && g1 > s0) s_blocks[nb++] = bb;
    }
    s_nblocks = nb;
  }
  __syncthreads();
  for (int e = tid; e < TILE * TILE; e += COMBINE_NT) {
    float v = 0.f;
    for (int i = 0; i < s_nblocks; ++i)
      v += part[((size_t)(s_blocks[i] + k) * P + p) * (TILE * TILE) + e];
    s[e / TILE][e % TILE] = v;
  }
  __syncthreads();
  float* gk = gram + (size_t)k * F * F;
  for (int e = tid; e < TILE * TILE; e += COMBINE_NT) {
    const int r = e / TILE, c = e % TILE;
    const int f = a * TILE + r, g = b * TILE + c;
    if (f >= F) continue;
    if (g < F && (a < b || r <= c))
      gk[(size_t)f * F + g] = s[r][c];
    else if (g == F)
      rhs[(size_t)k * F + f] = s[r][c];
  }
  // the mirror image: (b-row c, a-column r) = s[r][c]
  for (int e = tid; e < TILE * TILE; e += COMBINE_NT) {
    const int c = e / TILE, r = e % TILE;
    const int f = b * TILE + c, g = a * TILE + r;
    if (f < F && g < F && (a < b || r < c)) gk[(size_t)f * F + g] = s[r][c];
  }
}

struct Layout {
  int F, T, P, groups, B;
  size_t int_count, part_floats, bytes;
};

Layout layout(int K, int N, int D) {
  Layout l;
  l.F = D * (D + 1) / 2 + D + 1;
  l.T = (l.F + 1 + TILE - 1) / TILE;  // F features and the y column
  l.P = l.T * (l.T + 1) / 2;
  l.groups = (l.P + WG - 1) / WG;
  // the slab line cut so that the grid is one wave, two blocks per SM
  // (at most 2 * NUM_SMS ranges, which the last pass lists)
  l.B = max(1, 2 * NUM_SMS / l.groups);
  // cnt [K], start [K + 1], idx [K][N]; the scratch after them 16-aligned
  l.int_count = ((size_t)2 * K + 1 + (size_t)K * N + 3) / 4 * 4;
  l.part_floats = (size_t)(l.B + K) * l.P * TILE * TILE;
  l.bytes = l.int_count * sizeof(int) + l.part_floats * sizeof(float);
  return l;
}

}  // namespace

// Bytes of scratch gmmvi_more_grams needs for these sizes.
extern "C" size_t gmmvi_more_grams_workspace(int K, int N, int D) {
  return layout(K, N, D).bytes;
}

// gram [K, F, F] and rhs [K, F] with F = D(D+1)/2 + D + 1, from inv_chols
// [K, D, D], means [K, D], w [K, N], y [N], x [N, D]; all float32,
// contiguous, on the current device; ws of gmmvi_more_grams_workspace bytes
// (16-byte aligned).  1 <= D <= 45, 1 <= K <= 65,535.
extern "C" int gmmvi_more_grams(const float* inv_chols, const float* means,
                                const float* w, const float* y,
                                const float* x, float* gram, float* rhs,
                                void* ws, int K, int N, int D, void* stream) {
  if (K < 1 || K > 65535 || D < 1 || D > MAX_D || N < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout l = layout(K, N, D);
  int* cnt = static_cast<int*>(ws);
  int* start = cnt + K;
  int* idx = start + K + 1;
  float* part = reinterpret_cast<float*>(static_cast<int*>(ws) + l.int_count);
  more_compact_kernel<<<K, COMPACT_NT, 0, st>>>(w, idx, cnt, N);
  more_schedule_kernel<<<1, SCHED_NT, 0, st>>>(cnt, start, K);
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      more_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  more_mma_kernel<<<dim3(l.B, l.groups), NT, smem, st>>>(
      inv_chols, means, w, y, x, idx, cnt, start, part, K, N, D, l.T, l.P,
      l.B);
  more_combine_kernel<<<dim3(l.P, K), COMBINE_NT, 0, st>>>(
      part, start, gram, rhs, l.F, l.T, l.P, l.B);
  return (int)cudaGetLastError();
}
