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
// What bounds it on this card: the tensor cores, once the operands are
// reused enough.  The moment is a batched GEMM (w_k o G)^T Xc of K N D^2 =
// 4.3e10 multiply-adds at the stm300 shapes (K = 40, N = 12,000, D = 300)
// against ~31 MB of inputs and output; taken as three TF32 products
// (3xTF32, tf32x3.cuh: float32 accuracy, which fp32 FMA on the CUDA cores
// gave at a third of their 67 TFLOP/s) it is 2.6e11 tensor-core FLOP,
// ~0.52 ms at 495 TFLOP/s.  The operands come from L2 (G and Xc are read
// by every component and tile), whose rate to an SM is short of the tensor
// cores' appetite unless each slab copied is used for several products.
//
// Design.  A pre-pass writes the operands slab by slab in the image a
// stage of shared memory holds (tf32x3.cuh): G^T in 64 x 32 A slabs, Xc^T
// split into its TF32 halves in 32 x 64 B slabs (zeros past D and N), the
// weights padded to a multiple of 32 samples, and for every (component,
// 32-sample slab) a flag "some weight is nonzero".  The main kernel gives
// one block of four warpgroups a 64 x 64 tile of the D x D output for four
// components, one per warpgroup: 5 x 5 x 10 = 250 blocks at stm300.  The
// four share each slab of G^T and Xc, so a block copies 25 KB per 32
// samples for four components' products.  It walks the slabs in which one
// of its components has weight (a slab whose weights are all zero adds
// nothing: padded slots and invalid samples carry weight 0, and at stm300
// self-normalized weights of far-apart components underflow to 0, so the
// path's own inputs skip most slabs and no copy is issued for them)
// through a ring of four stages, each filled by bulk copies that one
// thread issues on an mbarrier: the copies of the next three slabs run
// while the tensor cores work on this one.  A warpgroup whose own
// component has no weight in a slab skips its products there.  The weight
// is folded into A = (w_k o G)^T in registers, which are split after the
// fold; B = Xc comes from shared memory.  Each slab's twelve wgmma (four
// steps of 8 samples, three products each) start from zero and are added
// into a separate fp32 register sum, so the tensor core's own
// accumulation never spans more than 32 samples.  Only the [K, D, D]
// moments reach device memory.
#include "tf32x3.cuh"

namespace {

using tf32x3::KS;
using tf32x3::SLAB;
using tf32x3::SLAB_BYTES;
using tf32x3::TILE;

constexpr int MAX_D = 512;
constexpr int GROUP = 4;            // components (warpgroups) per block
constexpr int NT = 128 * GROUP;
constexpr int STAGES = 4;

struct Stage {
  float a[SLAB];         // G^T slab: rows d0.., samples n0..
  float bh[SLAB];        // Xc^T's TF32 halves: samples n0.., columns e0..
  float bl[SLAB];
  float w[GROUP][KS];    // the group's weights on the slab
};

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Pre-pass 1: for the tile (64 dimensions, 32 samples) of this block, the
// A slab of G^T and the B slabs of Xc^T's halves, written in image order.
__global__ void stein_tiles_kernel(const float* __restrict__ g,
                                   const float* __restrict__ xc,
                                   float* __restrict__ ga,
                                   float* __restrict__ xbh,
                                   float* __restrict__ xbl, int N, int D,
                                   int nslab) {
  __shared__ float tg[TILE][KS + 1], tx[TILE][KS + 1];  // [d][n]
  const int slab = blockIdx.x, dt = blockIdx.y;
  const int n0 = slab * KS, d0 = dt * TILE;
  for (int i = threadIdx.x; i < KS * TILE; i += blockDim.x) {
    const int n = i / TILE, d = i % TILE;  // reads along d
    const bool in = n0 + n < N && d0 + d < D;
    const size_t src = (size_t)(n0 + n) * D + d0 + d;
    tg[d][n] = in ? g[src] : 0.f;
    tx[d][n] = in ? xc[src] : 0.f;
  }
  __syncthreads();
  const size_t o = ((size_t)dt * nslab + slab) * SLAB;
  for (int i = threadIdx.x; i < SLAB; i += blockDim.x) {
    // the image position i of either layout (writes in order)
    const int ar = i / KS, ac = ((((i % KS) >> 2) ^ (ar & 7)) << 2) + (i & 3);
    ga[o + i] = tg[ar][ac];
    const int bc = (i / (TILE * 4)) * 4 + (i & 3), br = (i / 4) % TILE;
    uint32_t hi, lo;
    tf32x3::split(tx[br][bc], hi, lo);
    xbh[o + i] = __uint_as_float(hi);
    xbl[o + i] = __uint_as_float(lo);
  }
}

// Pre-pass 2: wp [K, N'] (zeros past N) and live[k][slab] = some weight of
// the slab is nonzero.
__global__ void stein_weights_kernel(const float* __restrict__ w,
                                     float* __restrict__ wp,
                                     int* __restrict__ live, int N,
                                     int nslab) {
  const int k = blockIdx.y, slab = blockIdx.x, n = slab * KS + threadIdx.x;
  const float v = n < N ? w[(size_t)k * N + n] : 0.f;
  wp[(size_t)k * nslab * KS + n] = v;
  const bool any = __any_sync(0xffffffffu, v != 0.f);
  if (threadIdx.x == 0) live[(size_t)k * nslab + slab] = any;
}

// The main pass: out[k] tile (d0.., e0..) for the block's components k,
// over the slabs where one of them has weight.
__global__ void __launch_bounds__(NT, 1)
stein_mma_kernel(const float* __restrict__ ga, const float* __restrict__ xbh,
                 const float* __restrict__ xbl, const float* __restrict__ wp,
                 const int* __restrict__ live, float* __restrict__ out,
                 int K, int D, int nslab, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  Stage* st = reinterpret_cast<Stage*>(smem);
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ int s_slab[STAGES];
  const int tid = threadIdx.x, wg = tid / 128;
  const int dt = blockIdx.x / tiles, et = blockIdx.x % tiles;
  const int k0 = blockIdx.y * GROUP, nk = min(GROUP, K - k0);
  const int k = k0 + wg;  // this warpgroup's component (if k < K)

  auto group_live = [&](int slab) {
    bool any = false;
    for (int c = 0; c < nk; ++c) any |= live[(size_t)(k0 + c) * nslab + slab];
    return any;
  };
  int count = 0;  // the slabs the block visits
  for (int base = 0; base < nslab; base += NT)
    count += __syncthreads_count(base + tid < nslab && group_live(base + tid));

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) tf32x3::mbar_init(&full[s], 1);
    tf32x3::mbar_init_fence();
  }
  __syncthreads();

  // the producer (thread 0): its cursor over the slabs the block visits
  int next = 0;
  auto issue = [&](int stage) {
    while (next < nslab && !group_live(next)) ++next;
    if (next >= nslab) return;
    Stage& s = st[stage];
    s_slab[stage] = next;
    tf32x3::mbar_expect(&full[stage], 3 * SLAB_BYTES + nk * KS * 4);
    tf32x3::bulk_copy(s.a, ga + ((size_t)dt * nslab + next) * SLAB,
                      SLAB_BYTES, &full[stage]);
    const size_t b = ((size_t)et * nslab + next) * SLAB;
    tf32x3::bulk_copy(s.bh, xbh + b, SLAB_BYTES, &full[stage]);
    tf32x3::bulk_copy(s.bl, xbl + b, SLAB_BYTES, &full[stage]);
    for (int c = 0; c < nk; ++c)
      tf32x3::bulk_copy(s.w[c], wp + ((size_t)(k0 + c) * nslab + next) * KS,
                        KS * 4, &full[stage]);
    ++next;
  };

  float tot[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = 0.f;
  if (tid == 0)
    for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int s = 0; s < count; ++s) {
    // every thread is done with slab s - 1's stage: refill it
    __syncthreads();
    if (tid == 0) {
      tf32x3::fence_async_smem();
      issue((s + STAGES - 1) % STAGES);
    }
    const int stage = s % STAGES;
    tf32x3::mbar_wait(&full[stage], (s / STAGES) & 1);
    const Stage& cur = st[stage];
    if (k < K && live[(size_t)k * nslab + s_slab[stage]]) {
      const float* wk = cur.w[wg];
      float av[KS / 8][4];
      tf32x3::load_a(cur.a, av, [&](float v, int c) { return wk[c] * v; });
      tf32x3::slab_product(acc, av, cur.bh, cur.bl);
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[i] += acc[i];
    }
  }
  if (k >= K) return;

  const int lane = tid & 31, r0 = 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int d0 = dt * TILE, e0 = et * TILE;
  float* ok = out + (size_t)k * D * D;
#pragma unroll
  for (int c = 0; c < TILE / 8; ++c) {
    const int e = e0 + 8 * c + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = d0 + r0 + 8 * h;
      if (d >= D) continue;
      if (e < D) ok[(size_t)d * D + e] = tot[4 * c + 2 * h];
      if (e + 1 < D) ok[(size_t)d * D + e + 1] = tot[4 * c + 2 * h + 1];
    }
  }
}

struct Layout {
  int nslab, tiles;
  size_t t_floats, w_floats, bytes, smem;
};

Layout layout(int K, int N, int D) {
  Layout l;
  l.nslab = ceil_div(N > 0 ? N : 1, KS);
  l.tiles = ceil_div(D, TILE);
  l.t_floats = (size_t)l.tiles * l.nslab * SLAB;
  l.w_floats = (size_t)K * l.nslab * KS;
  l.bytes = (3 * l.t_floats + l.w_floats) * sizeof(float) +
            (size_t)K * l.nslab * sizeof(int);
  l.smem = STAGES * sizeof(Stage);
  return l;
}

}  // namespace

// Bytes of scratch gmmvi_stein_smom needs for these sizes.
extern "C" size_t gmmvi_stein_smom_workspace(int K, int N, int D) {
  return layout(K, N, D).bytes;
}

// out [K, D, D] from w [K, N], g [N, D] and xc [N, D]; all float32,
// contiguous, on the current device; ws of gmmvi_stein_smom_workspace
// bytes (16-byte aligned).  1 <= D <= 512, 1 <= K <= 65,535.
extern "C" int gmmvi_stein_smom(const float* w, const float* g,
                                const float* xc, float* out, void* ws, int K,
                                int N, int D, void* stream) {
  // K rides a grid's y axis (at most 65,535 blocks)
  if (K < 1 || K > 65535 || D < 1 || D > MAX_D || N < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout l = layout(K, N, D);
  float* ga = static_cast<float*>(ws);
  float* xbh = ga + l.t_floats;
  float* xbl = xbh + l.t_floats;
  float* wp = xbl + l.t_floats;
  int* live = reinterpret_cast<int*>(wp + l.w_floats);
  stein_tiles_kernel<<<dim3(l.nslab, l.tiles), 256, 0, st>>>(
      g, xc, ga, xbh, xbl, N, D, l.nslab);
  stein_weights_kernel<<<dim3(l.nslab, K), KS, 0, st>>>(w, wp, live, N,
                                                        l.nslab);
  cudaError_t err = cudaFuncSetAttribute(
      stein_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  stein_mma_kernel<<<dim3(l.tiles * l.tiles, ceil_div(K, GROUP)), NT, l.smem,
                     st>>>(ga, xbh, xbl, wp, live, out, K, D, l.nslab,
                           l.tiles);
  return (int)cudaGetLastError();
}
