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
// ~3 MB of inputs and outputs.  On the tensor cores the triangle would be
// padded to 24 x 24 and taken three times (3xTF32): no better than the
// fp32 bound.  So the arithmetic stays fp32 FMA, and the design feeds it.
//
// Design.
// 1. A pre-pass packs the live rows once, in order (each block finds its
//    row's rank with block-wide counts, no atomics): per row, the lower
//    triangle with each row padded to a multiple of 4 (row i at off(i),
//    16-byte aligned, zeros past the diagonal), the mean, and one folded
//    scalar -log|L_u| + logw_u - D/2 log 2 pi, into a contiguous buffer,
//    and the live count.
// 2. The main kernel gives a block 256 samples, two per thread, and one
//    contiguous share of the live rows.  One thread streams the share's
//    packed rows into a ring of three shared-memory stages with bulk
//    asynchronous copies (cp.async.bulk on an mbarrier), so the next rows'
//    copy runs under this row's whitening.  Each float4 broadcast load of a
//    factor row feeds eight FMAs (four entries, two samples).  Each thread
//    keeps the TPU kernel's online max / rescaled sum per sample.  D <= 32
//    runs an instance unrolled to exactly D; 33 <= D <= 128 a run-time loop
//    (an unrolled instance that wide takes nvcc minutes).
// 3. Where sample tiles alone would not fill the card (B9's 2,000 draws),
//    the live rows are split across blocks too, and a last pass combines
//    the partial (max, rescaled sum) pairs in a fixed order.  No atomics:
//    two calls give the same bits.
//
// Kernel B9, the mixture log-density, is the same function over a model's
// padded components (log weight -inf on the inactive slots): it replaces
// gmmvi_tpu/ops/pallas_kernels.py `_mixture_logpdf_kernel` (entry
// `fused_mixture_logpdf`), which streams the components with the same
// running max / rescaled sum.  Its entry `gmmvi_mixture_logpdf` launches
// these kernels; wrapper and plain version:
// gmmvi_tpu_torch/ops/mixture_logpdf.py.
#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr float LOG_2PI = 1.8378770664093453f;
constexpr int MAX_D = 128;
constexpr int MAX_EXACT_D = 32;   // unrolled instances for D <= 32
constexpr int NT = 128;           // threads per block
constexpr int R = 2;              // samples per thread
constexpr int TS = NT * R;        // samples per block
constexpr int STAGES = 3;
constexpr int STAGE_FLOATS = 2048;  // rows per stage: as many as fit 8 KB
constexpr int NUM_SMS = 132;        // H100 SXM: splits are sized to fill it
constexpr int PACK_NT = 256;

__host__ __device__ constexpr int pad4(int d) { return (d + 3) / 4 * 4; }

// start of factor row i in a packed row: rows padded to multiples of 4
__host__ __device__ constexpr int tri_off(int i) {
  return 8 * (i / 4) * (i / 4 + 1) + 4 * (i % 4) * (i / 4 + 1);
}

// floats of one packed row: triangle, mean, folded scalar (+ 3 zeros)
__host__ __device__ constexpr int row_floats(int d) {
  return tri_off(d) + pad4(d) + 4;
}

// Pre-pass: block u < U packs row u at its rank among the live rows; block
// U writes the live count to *count.
__global__ void __launch_bounds__(PACK_NT)
background_pack_kernel(const float* __restrict__ means,
                       const float* __restrict__ inv_chols,
                       const float* __restrict__ logw,
                       const float* __restrict__ logdets,
                       float* __restrict__ packed, int* __restrict__ count,
                       int U, int D) {
  const int u = blockIdx.x, tid = threadIdx.x;
  int rank = 0;
  for (int base = 0; base < u; base += PACK_NT)
    rank +=
        __syncthreads_count(base + tid < u && logw[base + tid] > -INFINITY);
  if (u == U) {
    if (tid == 0) *count = rank;
    return;
  }
  if (!(logw[u] > -INFINITY)) return;
  float* dst = packed + (size_t)rank * row_floats(D);
  const float* l = inv_chols + (size_t)u * D * D;
  const int d4 = pad4(D);
  for (int e = tid; e < D * d4; e += PACK_NT) {
    const int i = e / d4, j = e - i * d4;
    if (j < pad4(i + 1)) dst[tri_off(i) + j] = j <= i ? l[i * D + j] : 0.f;
  }
  const int mo = tri_off(D);
  for (int j = tid; j < d4 + 4; j += PACK_NT) {
    float v = 0.f;
    if (j < D)
      v = means[(size_t)u * D + j];
    else if (j == d4)
      v = -logdets[u] + logw[u] - 0.5f * (float)D * LOG_2PI;
    dst[mo + j] = v;
  }
}

// |L^{-1}(x_r - mu)|^2 for this thread's R samples against the packed row
// p; DK = D (unrolled) or 0 (run-time loops, D <= MAX_D).
template <int DK>
struct Whiten {
  static constexpr int W = DK > 0 ? DK : MAX_D;
  float x[R][W];
  float v[R][W];

  __device__ __forceinline__ void maha(const float* __restrict__ p, int D,
                                       float (&out)[R]) {
    const float* mu = p + tri_off(DK > 0 ? DK : D);
    if constexpr (DK > 0) {
#pragma unroll
      for (int g = 0; g < pad4(DK) / 4; ++g) {
        const float4 m4 = *reinterpret_cast<const float4*>(mu + 4 * g);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * g + e < DK)
#pragma unroll
            for (int r = 0; r < R; ++r)
              v[r][4 * g + e] = x[r][4 * g + e] - mv[e];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) out[r] = 0.f;
      // rows from last to first: row i reads diff_0..diff_i, and the rows
      // below i have stopped needing diff_i
#pragma unroll
      for (int i = DK - 1; i >= 0; --i) {
        const float* row = p + tri_off(i);
        float yi[R];
#pragma unroll
        for (int r = 0; r < R; ++r) yi[r] = 0.f;
#pragma unroll
        for (int g = 0; g <= i / 4; ++g) {
          const float4 l4 = *reinterpret_cast<const float4*>(row + 4 * g);
          const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * g + e <= i)
#pragma unroll
              for (int r = 0; r < R; ++r)
                yi[r] = fmaf(lv[e], v[r][4 * g + e], yi[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          v[r][i] = yi[r];
          out[r] = fmaf(yi[r], yi[r], out[r]);
        }
      }
    } else {
      for (int j = 0; j < D; ++j)
#pragma unroll
        for (int r = 0; r < R; ++r) v[r][j] = x[r][j] - mu[j];
#pragma unroll
      for (int r = 0; r < R; ++r) out[r] = 0.f;
      for (int i = D - 1; i >= 0; --i) {
        const float* row = p + tri_off(i);
        float yi[R];
#pragma unroll
        for (int r = 0; r < R; ++r) yi[r] = 0.f;
        int j = 0;
        for (; j + 3 <= i; j += 4) {
          const float4 l4 = *reinterpret_cast<const float4*>(row + j);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            yi[r] = fmaf(l4.x, v[r][j], yi[r]);
            yi[r] = fmaf(l4.y, v[r][j + 1], yi[r]);
            yi[r] = fmaf(l4.z, v[r][j + 2], yi[r]);
            yi[r] = fmaf(l4.w, v[r][j + 3], yi[r]);
          }
        }
        for (; j <= i; ++j)
#pragma unroll
          for (int r = 0; r < R; ++r) yi[r] = fmaf(row[j], v[r][j], yi[r]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          v[r][i] = yi[r];
          out[r] = fmaf(yi[r], yi[r], out[r]);
        }
      }
    }
  }
};

// Main pass: samples [tile * TS, +TS), live rows of split blockIdx.y.
// With splits == 1 it writes out[n]; else the partial (max, sum) pairs to
// part_m / part_s [splits][N].
template <int DK>
__global__ void __launch_bounds__(NT)
background_kernel(const float* __restrict__ packed,
                  const int* __restrict__ count, const float* __restrict__ xs,
                  float* __restrict__ out, float* __restrict__ part_m,
                  float* __restrict__ part_s, int N, int D, int rows_per_stage,
                  int splits) {
  extern __shared__ __align__(128) float stage_mem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  const int tid = threadIdx.x;
  const int rw = row_floats(D);
  const int nlive = *count;
  const int r_lo = (int)((long long)nlive * blockIdx.y / splits);
  const int r_hi = (int)((long long)nlive * (blockIdx.y + 1) / splits);
  const int nch = (r_hi - r_lo + rows_per_stage - 1) / rows_per_stage;
  const int stage_floats = rows_per_stage * rw;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) tf32x3::mbar_init(&full[s], 1);
    tf32x3::mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int ch) {  // thread 0 only
    if (ch >= nch) return;
    const int r0 = r_lo + ch * rows_per_stage;
    const uint32_t bytes = min(rows_per_stage, r_hi - r0) * rw * 4;
    uint64_t* bar = &full[ch % STAGES];
    tf32x3::mbar_expect(bar, bytes);
    tf32x3::bulk_copy(stage_mem + (ch % STAGES) * stage_floats,
                      packed + (size_t)r0 * rw, bytes, bar);
  };
  if (tid == 0)
    for (int c = 0; c < STAGES - 1; ++c) issue(c);

  Whiten<DK> wh;
  int n[R];
  constexpr int W = Whiten<DK>::W;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    n[r] = blockIdx.x * TS + r * NT + tid;
    const bool ok = n[r] < N;
    if constexpr (DK > 0) {
#pragma unroll
      for (int j = 0; j < W; ++j)
        wh.x[r][j] = ok ? xs[(size_t)n[r] * D + j] : 0.f;
    } else {
      for (int j = 0; j < D; ++j)
        wh.x[r][j] = ok ? xs[(size_t)n[r] * D + j] : 0.f;
    }
  }

  float m[R], s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  for (int ch = 0; ch < nch; ++ch) {
    // every thread is done with chunk ch - 1's stage: refill it
    __syncthreads();
    if (tid == 0) {
      tf32x3::fence_async_smem();
      issue(ch + STAGES - 1);
    }
    tf32x3::mbar_wait(&full[ch % STAGES], (ch / STAGES) & 1);
    const float* st = stage_mem + (ch % STAGES) * stage_floats;
    const int rows = min(rows_per_stage, r_hi - (r_lo + ch * rows_per_stage));
    for (int c = 0; c < rows; ++c) {
      const float* p = st + c * rw;
      float q[R];
      wh.maha(p, D, q);
      const float cst = p[tri_off(D) + pad4(D)];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float w = fmaf(-0.5f, q[r], cst);
        if (!(w > -INFINITY)) continue;
        if (w > m[r]) {
          s[r] = s[r] * expf(m[r] - w) + 1.f;
          m[r] = w;
        } else {
          s[r] += expf(w - m[r]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (n[r] >= N) continue;
    if (splits == 1) {
      out[n[r]] = s[r] > 0.f ? m[r] + logf(s[r]) : -INFINITY;
    } else {
      part_m[(size_t)blockIdx.y * N + n[r]] = m[r];
      part_s[(size_t)blockIdx.y * N + n[r]] = s[r];
    }
  }
}

// Last pass where the rows were split: the splits' pairs in order.
__global__ void background_combine_kernel(const float* __restrict__ part_m,
                                          const float* __restrict__ part_s,
                                          float* __restrict__ out, int N,
                                          int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float mx = -INFINITY;
  for (int r = 0; r < splits; ++r) mx = fmaxf(mx, part_m[(size_t)r * N + n]);
  float sum = 0.f;
  for (int r = 0; r < splits; ++r) {
    const float mr = part_m[(size_t)r * N + n];
    if (mr > -INFINITY) sum += part_s[(size_t)r * N + n] * expf(mr - mx);
  }
  out[n] = sum > 0.f ? mx + logf(sum) : -INFINITY;
}

struct Layout {
  int tiles, splits, rows_per_stage;
  size_t packed_floats, part_floats, bytes, smem;
};

Layout layout(int U, int N, int D) {
  Layout l;
  const int rw = row_floats(D);
  l.tiles = (N + TS - 1) / TS;
  // rows split across blocks where the sample tiles give fewer than about
  // four blocks per SM, at least 8 rows a split
  const int want = (4 * NUM_SMS + l.tiles - 1) / max(l.tiles, 1);
  l.splits = max(1, min(want, (U + 7) / 8));
  l.rows_per_stage = max(1, STAGE_FLOATS / rw);
  l.packed_floats = (size_t)max(U, 1) * rw;
  l.part_floats = l.splits > 1 ? (size_t)2 * l.splits * N : 0;
  l.bytes = 16 + (l.packed_floats + l.part_floats) * sizeof(float);
  l.smem = (size_t)STAGES * l.rows_per_stage * rw * sizeof(float);
  return l;
}

template <int DK>
cudaError_t launch(const float* packed, const int* count, const float* x,
                   float* out, float* part, const Layout& l, int N, int D,
                   cudaStream_t st) {
  if (l.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        background_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)l.smem);
    if (err != cudaSuccess) return err;
  }
  float* part_m = part;
  float* part_s = part ? part + (size_t)l.splits * N : nullptr;
  background_kernel<DK><<<dim3(l.tiles, l.splits), NT, l.smem, st>>>(
      packed, count, x, out, part_m, part_s, N, D, l.rows_per_stage,
      l.splits);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_exact(int D, const float* packed, const int* count,
                         const float* x, float* out, float* part,
                         const Layout& l, int N, cudaStream_t st) {
  if constexpr (DK > MAX_EXACT_D) {
    return launch<0>(packed, count, x, out, part, l, N, D, st);
  } else {
    if (D == DK) return launch<DK>(packed, count, x, out, part, l, N, D, st);
    return launch_exact<DK + 1>(D, packed, count, x, out, part, l, N, st);
  }
}

int launch_any(const float* means, const float* inv_chols, const float* logw,
               const float* logdets, const float* x, float* out, void* ws,
               int U, int N, int D, void* stream) {
  if (U < 0 || D < 1 || D > MAX_D || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout l = layout(U, N, D);
  int* count = static_cast<int*>(ws);
  float* packed = reinterpret_cast<float*>(static_cast<char*>(ws) + 16);
  float* part = l.splits > 1 ? packed + l.packed_floats : nullptr;
  background_pack_kernel<<<U + 1, PACK_NT, 0, st>>>(
      means, inv_chols, logw, logdets, packed, count, U, D);
  cudaError_t err = launch_exact<1>(D, packed, count, x, out, part, l, N, st);
  if (err != cudaSuccess) return (int)err;
  if (l.splits > 1)
    background_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(
        part, part + (size_t)l.splits * N, out, N, l.splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch gmmvi_background and gmmvi_mixture_logpdf need for these
// sizes.
extern "C" size_t gmmvi_background_workspace(int U, int N, int D) {
  return layout(U, N, D).bytes;
}

// out [N]; all arrays float32, contiguous, on the current device; ws of
// gmmvi_background_workspace bytes (16-byte aligned).  1 <= D <= 128,
// U >= 0.
extern "C" int gmmvi_background(const float* means, const float* inv_chols,
                                const float* logw, const float* logdets,
                                const float* x, float* out, void* ws, int U,
                                int N, int D, void* stream) {
  return launch_any(means, inv_chols, logw, logdets, x, out, ws, U, N, D,
                    stream);
}

// B9: out [N] = logsumexp_k(log N(x_n; mu_k, Sigma_k) + logw_k) over the K
// slots with a finite log weight, -inf where there is none.  Same arguments
// and limits as gmmvi_background, with K in place of U.
extern "C" int gmmvi_mixture_logpdf(const float* means, const float* inv_chols,
                                    const float* logw, const float* logdets,
                                    const float* x, float* out, void* ws,
                                    int K, int N, int D, void* stream) {
  return launch_any(means, inv_chols, logw, logdets, x, out, ws, K, N, D,
                    stream);
}
