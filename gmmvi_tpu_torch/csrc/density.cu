// Mixture density passes for Hopper (sm_90a): kernels B1 and B2.
//
// Replaces the TPU kernels gmmvi_tpu/ops/pallas_density.py
// `_density_pack_kernel` (B1: component log-densities, mixture logsumexp and
// analytic mixture gradients) and `_densities_kernel` (B2: the first two
// only).  Python wrapper and plain version: gmmvi_tpu_torch/ops/density.py.
// For K slots given by means [K, D], lower-triangular inverse Cholesky
// factors L_k [K, D, D], log weights [K] (-inf marks a masked slot) and
// log|C_k| [K] (C_k = L_k^-1, the covariance's Cholesky factor), over
// samples x [N, D]:
//
//   comp[k, n] = -|y_kn|^2 / 2 - log|C_k| - D/2 log 2 pi
//   y_kn       = L_k (x_n - mu_k)
//   model[n]   = logsumexp_k (comp[k, n] + log w_k) over the live slots
//   grads[n]   = -sum_k r_kn L_k^T y_kn,  r_kn = exp(comp + log w_k - model)
//
// (B1 all three, B2 the first two; comp for every slot, masked or not;
// model -inf and grads 0 where every slot is masked.)
//
// What bounds it on this card: fp32 FMAs.  Every slot whitens every sample,
// D(D+1)/2 FMAs, and B1 takes L^T y once more for the live slots.  At the
// reuse path's window (K = 48, 45 live, D = 20, N = 28,800) that is ~0.56
// GFMA against ~8 MB of inputs and outputs.  On the tensor cores the
// triangle would be padded to 24 x 24 and taken three times (3xTF32): no
// better than the fp32 bound, so the arithmetic stays fp32 FMA (as B4's),
// and the design feeds it.
//
// Design.
// 1. One pass.  B1's gradient is accumulated in the same sweep as the
//    logsumexp, with the rescaling of flash attention: per sample the
//    running max m, the rescaled sum s = sum_k exp(w_k - m) and the rescaled
//    accumulator a = sum_k exp(w_k - m) L_k^T y_k, w_k = comp_k + log w_k;
//    where m grows, s and a are scaled by exp(m_old - m_new).  At the end
//    model = m + log s and grads = -a / s.  So each (sample, live slot)
//    pair costs two triangular products, y and L^T y, with y still in
//    registers, and each parameter is read once.  A coefficient that
//    underflows to zero skips the second product.  (Two passes instead,
//    the second taking y and L^T y again only for the slots that carry
//    weight in a block, measured slower on every path's inputs: there a
//    sample carries weight in 11 to 23 slots, not in one, and a block's
//    64 samples in 15 to 33 of 45; scripts/torch_bench_density_kernels.py
//    prints both counts.)
// 2. Streamed parameters.  All threads of a block copy the slots, each
//    factor row to a row of the triangle padded to a multiple of 4 (row i
//    at tri_off(i), 16-byte aligned), the mean, log|C| and log w, into a
//    ring of shared-memory stages with asynchronous copies (cp.async: 16
//    bytes at a time where D is a multiple of 4, else 4), so the next slots'
//    copy runs under this slot's work.  No pre-pass, no workspace: a call is
//    one launch, as before.
// 3. Register blocking.  A thread keeps 2 samples (y and, for B1, a in
//    registers; x in shared memory, once for the 4 warps), so each float4
//    broadcast of a factor row feeds eight FMAs.  D <= 32 runs an
//    instance unrolled to D rounded up to a multiple of 4 (8 instances a
//    kernel; the padded rows, mean and sample entries are zeros, so they
//    add nothing), 33 <= D <= 128 a run-time loop over 4 x 4 register
//    blocks, one sample a thread, with x, y and a in local memory.  B1's
//    second product reloads the factor with volatile loads: with plain
//    ones ptxas kept the whitening's loads live for it (the whole triangle
//    in registers) and spilled.
// 4. Slot groups.  A block is 4 warps over the same samples, each warp a
//    group that takes every fourth slot of the stream (64 samples a
//    block), which gives 4x the warps N alone would.  At the end the
//    groups' (m, s[, a]) are combined in a fixed order through shared
//    memory, and model and grads are written coalesced (comp is, as it
//    goes).  No atomics: two calls give the same bits.  (The run-time
//    instance takes fewer groups where 4 slots a stage would not fit the
//    shared memory.)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG_2PI = 1.8378770664093453f;
constexpr int MAX_D = 128;
constexpr int MAX_UNROLLED_D = 32;  // unrolled instances for D <= 32
constexpr int TX = 32;              // threads of a slot group (one warp)
constexpr int G = 4;                // slot groups of a block
constexpr int NT = TX * G;          // threads per block
constexpr int STAGES = 3;           // ring stages of the unrolled instances
constexpr int WIDE_STAGES = 2;      // of the run-time instance
constexpr int WIDE_RING_BYTES = 72 * 1024;

__host__ __device__ constexpr int pad4(int d) { return (d + 3) / 4 * 4; }

// start of factor row i in a packed slot: rows padded to multiples of 4
__host__ __device__ constexpr int tri_off(int i) {
  return 8 * (i / 4) * (i / 4 + 1) + 4 * (i % 4) * (i / 4 + 1);
}

// floats of one slot in a stage: triangle, mean, log|C|, log w (+ 2 spare)
__host__ __device__ constexpr int row_floats(int d) {
  return tri_off(d) + pad4(d) + 4;
}

struct Args {
  const float* means;
  const float* inv_chols;
  const float* logw;
  const float* logdets;
  const float* xs;
  float* comp;
  float* model;
  float* grads;
  int K, N, D;
  bool vec;  // factor rows copied 16 bytes at a time: D % 4 == 0, aligned
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// 4 floats of the stage as a volatile load, which ptxas performs as
// written: B1's second product reads the factor this way, since from two
// plain loads of one address ptxas keeps the first live, and it kept the
// whitening's whole triangle in registers for the second product (D(D+1)/2
// of them), which spilled at the main path's D = 20
// (scripts/torch_bench_density_kernels.py builds and times a copy with
// plain loads beside this one).
__device__ __forceinline__ float4 lds4_volatile(const float* p) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_u32(p)));
  return v;
}

// The layout of a stage: slots of rw = row_floats(DL) floats, each the
// factor's rows padded to multiples of 4 (row i at tri_off(i)), the mean at
// tri_off(DL), log|C| and log w after it; spc slots a stage.  The copies
// fill the first D rows and entries (D <= DL; the rest stays as the kernel
// set it).
struct Stage {
  int D, DL, rw, spc;
};

// Copy slots k0 .. k0 + nk - 1 into the stage st, by all nt threads:
// thread pairs (slot, row i) copy factor row i (entries past the diagonal
// are never read) and the mean's entry i.
__device__ __forceinline__ void stage_slots(const Args& a, const Stage& l,
                                            float* st, int k0, int nk,
                                            int tid, int nt) {
  const int D = l.D;
  for (int p = tid; p < nk * D; p += nt) {
    const int c = p / D, i = p - c * D;
    const float* src = a.inv_chols + ((size_t)(k0 + c) * D + i) * D;
    float* dst = st + c * l.rw + tri_off(i);
    if (a.vec) {
      for (int j = 0; j <= i; j += 4) cp16(dst + j, src + j);
    } else {
      for (int j = 0; j <= i; ++j) cp4(dst + j, src + j);
    }
    cp4(st + c * l.rw + tri_off(l.DL) + i,
        a.means + (size_t)(k0 + c) * D + i);
  }
  for (int c = tid; c < nk; c += nt) {
    float* dst = st + c * l.rw + tri_off(l.DL) + pad4(l.DL);
    cp4(dst, a.logdets + k0 + c);
    cp4(dst + 1, a.logw + k0 + c);
  }
}

// The ring of NSTAGES stages: ring_start queues the first NSTAGES - 1
// chunks of spc slots; ring_next(ch) waits for chunk ch, queues chunk
// ch + NSTAGES - 1 into the stage chunk ch - 1 used, and returns chunk ch's
// stage; after the last chunk, ring_end frees the ring.  Called by all nt
// threads.
template <int NSTAGES>
__device__ __forceinline__ void ring_start(const Args& a, const Stage& l,
                                           float* ring, int tid, int nt) {
  const int nch = (a.K + l.spc - 1) / l.spc;
#pragma unroll
  for (int s = 0; s < NSTAGES - 1; ++s) {
    if (s < nch)
      stage_slots(a, l, ring + s * l.spc * l.rw, s * l.spc,
                  min(l.spc, a.K - s * l.spc), tid, nt);
    cp_commit();
  }
}

template <int NSTAGES>
__device__ __forceinline__ const float* ring_next(const Args& a,
                                                  const Stage& l, float* ring,
                                                  int ch, int tid, int nt) {
  const int nch = (a.K + l.spc - 1) / l.spc;
  // this thread's copies of chunk ch have landed; the barrier makes every
  // thread's visible and frees the stage of chunk ch - 1
  cp_wait<NSTAGES - 2>();
  __syncthreads();
  const int nx = ch + NSTAGES - 1;
  if (nx < nch)
    stage_slots(a, l, ring + (nx % NSTAGES) * l.spc * l.rw, nx * l.spc,
                min(l.spc, a.K - nx * l.spc), tid, nt);
  cp_commit();
  return ring + (ch % NSTAGES) * l.spc * l.rw;
}

__device__ __forceinline__ void ring_end() {
  cp_wait<0>();
  __syncthreads();
}

// The online update of one sample by one slot's weighted log-density w:
// sc scales the old (s, a), c weighs the new term.
__device__ __forceinline__ void online(float w, float& m, float& s, float& sc,
                                       float& c) {
  sc = 1.f;
  c = 0.f;
  if (!(w > -INFINITY)) return;  // a masked slot (or a NaN)
  if (w > m) {
    sc = expf(m - w);
    c = 1.f;
    m = w;
  } else {
    c = expf(w - m);
  }
  s = fmaf(s, sc, c);
}

// Last step, after every group wrote its per-sample (m, s) to cm / cs
// [groups][ts] and, for B1, its a to ca [groups][ts * D]: model for the
// block's samples and, for B1, grads, both coalesced.
template <bool GRADS>
__device__ __forceinline__ void finish(const Args& a, float* cm,
                                       const float* cs, const float* ca,
                                       int base, int ts, int groups, int D,
                                       int tid, int nt) {
  const int rows = min(ts, a.N - base);
  for (int ls = tid; ls < rows; ls += nt) {
    float mx = -INFINITY;
    for (int g = 0; g < groups; ++g) mx = fmaxf(mx, cm[g * ts + ls]);
    float sum = 0.f;
    for (int g = 0; g < groups; ++g) {
      const float mg = cm[g * ts + ls];
      if (mg > -INFINITY) sum = fmaf(cs[g * ts + ls], expf(mg - mx), sum);
    }
    a.model[base + ls] = sum > 0.f ? mx + logf(sum) : -INFINITY;
    if constexpr (GRADS) {
      // each group's share of the responsibilities: exp(m_g - max) / sum
      for (int g = 0; g < groups; ++g) {
        const float mg = cm[g * ts + ls];
        cm[g * ts + ls] = mg > -INFINITY ? expf(mg - mx) / sum : 0.f;
      }
    }
  }
  if constexpr (GRADS) {
    __syncthreads();
    for (int idx = tid; idx < rows * D; idx += nt) {
      const int ls = idx / D;
      float acc = 0.f;
      for (int g = 0; g < groups; ++g)
        acc = fmaf(ca[(size_t)g * ts * D + idx], cm[g * ts + ls], acc);
      a.grads[(size_t)base * D + idx] = -acc;
    }
  }
}

// ---- unrolled instances, D <= 32 ----------------------------------------

// Rows I, I - 1, ..., 0 of y = L (x - mu) in place, for R samples: row i
// reads diff_0..diff_i, and the rows below i have stopped needing diff_i;
// q[r] += |y_i|^2.  Unrolled by template recursion, so that every loop has
// a constant trip count and v stays in registers.
template <int I, int DK, int R>
__device__ __forceinline__ void whiten_rows(const float* p, float (&v)[R][DK],
                                            float (&q)[R]) {
  if constexpr (I >= 0) {
    const float* row = p + tri_off(I);
    float yi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) yi[r] = 0.f;
#pragma unroll
    for (int g = 0; g <= I / 4; ++g) {
      const float4 l4 = *reinterpret_cast<const float4*>(row + 4 * g);
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * g + e <= I)
#pragma unroll
          for (int r = 0; r < R; ++r)
            yi[r] = fmaf(lv[e], v[r][4 * g + e], yi[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r][I] = yi[r];
      q[r] = fmaf(yi[r], yi[r], q[r]);
    }
    whiten_rows<I - 1, DK, R>(p, v, q);
  }
}

// v[r] <- y = L (x[r] - mu) for this thread's R samples (x[r] at xs[g * TS
// + ls[r]], 4 entries g a float4) against the slot p; q[r] = |y|^2.  DK =
// D rounded up to a multiple of 4: the padded rows, mean entries and
// sample entries are zeros.
template <int DK, int R, int TS>
__device__ __forceinline__ void whiten(const float* p, const float4* xs,
                                       const int (&ls)[R], float (&v)[R][DK],
                                       float (&q)[R]) {
  const float* mu = p + tri_off(DK);
#pragma unroll
  for (int g = 0; g < DK / 4; ++g) {
    const float4 m4 = *reinterpret_cast<const float4*>(mu + 4 * g);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x4 = xs[g * TS + ls[r]];
      v[r][4 * g] = x4.x - m4.x;
      v[r][4 * g + 1] = x4.y - m4.y;
      v[r][4 * g + 2] = x4.z - m4.z;
      v[r][4 * g + 3] = x4.w - m4.w;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) q[r] = 0.f;
  whiten_rows<DK - 1, DK, R>(p, v, q);
}

// acc[r] += L^T (c[r] y[r]) with y in v, rows I, I + 1, ..., DK - 1, the
// factor reloaded.
template <int I, int DK, int R>
__device__ __forceinline__ void add_back(const float* p,
                                         const float (&v)[R][DK],
                                         const float (&c)[R],
                                         float (&acc)[R][DK]) {
  if constexpr (I < DK) {
    const float* row = p + tri_off(I);
    float t[R];
#pragma unroll
    for (int r = 0; r < R; ++r) t[r] = c[r] * v[r][I];
#pragma unroll
    for (int g = 0; g <= I / 4; ++g) {
      const float4 l4 = lds4_volatile(row + 4 * g);
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * g + e <= I)
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r][4 * g + e] = fmaf(lv[e], t[r], acc[r][4 * g + e]);
    }
    add_back<I + 1, DK, R>(p, v, c, acc);
  }
}

// Samples [blockIdx.x * TS, +TS), TS = TX * R; warp g takes slots g,
// g + G, ...  The block's samples sit in shared memory as [DK / 4][TS]
// float4s (conflict-free reads) ahead of the ring.
template <int DK, bool GRADS>
__device__ __forceinline__ void density_stream(const Args& a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = 2, TS = TX * R, AW = GRADS ? DK : 1;
  constexpr int rw = row_floats(DK);
  const int D = a.D;
  const Stage lay{D, DK, rw, G};
  const int tx = threadIdx.x, g = threadIdx.y, tid = g * TX + tx;
  const int base = blockIdx.x * TS;
  const int rows = min(TS, a.N - base);
  float4* xs = reinterpret_cast<float4*>(smem);
  float* ring = smem + DK * TS;

  // the tile's rows of x are contiguous: (nearly) coalesced reads; zeros
  // past N and past D
  for (int idx = tid; idx < TS * DK; idx += NT) {
    const int ls = idx / DK, j = idx - ls * DK;
    reinterpret_cast<float*>(xs)[((j / 4) * TS + ls) * 4 + j % 4] =
        ls < rows && j < D ? a.xs[(size_t)(base + ls) * D + j] : 0.f;
  }
  // zeros in the padded rows and mean entries of every slot of the ring
  // (no copy writes there)
  const int zr = tri_off(DK) - tri_off(D), zn = zr + DK - D;
  for (int idx = tid; idx < STAGES * G * zn; idx += NT) {
    const int c = idx / zn, e = idx - c * zn;
    ring[c * rw + (e < zr ? tri_off(D) + e : tri_off(DK) + D + e - zr)] = 0.f;
  }

  float v[R][DK], acc[R][AW];
  int n[R], ls[R];
  float m[R], s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ls[r] = r * TX + tx;
    n[r] = base + ls[r];
#pragma unroll
    for (int j = 0; j < AW; ++j) acc[r][j] = 0.f;
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  const float half_log = -0.5f * (float)D * LOG_2PI;

  // (the first ring_next's barrier also publishes the samples and zeros)
  ring_start<STAGES>(a, lay, ring, tid, NT);
  for (int ch = 0; ch * G < a.K; ++ch) {
    const float* st = ring_next<STAGES>(a, lay, ring, ch, tid, NT);
    const int k = ch * G + g;
    if (k >= a.K) continue;
    const float* p = st + g * rw;
    float q[R];
    whiten<DK, R, TS>(p, xs, ls, v, q);
    const float* tail = p + tri_off(DK) + DK;
    const float cst = half_log - tail[0], lw = tail[1];
    float sc[R], c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float cv = fmaf(-0.5f, q[r], cst);
      if (n[r] < a.N) a.comp[(size_t)k * a.N + n[r]] = cv;
      online(cv + lw, m[r], s[r], sc[r], c[r]);
    }
    if constexpr (GRADS) {
      bool live = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (sc[r] < 1.f) {
#pragma unroll
          for (int j = 0; j < DK; ++j) acc[r][j] *= sc[r];
        }
        live |= c[r] != 0.f;
      }
      if (live) add_back<0, DK, R>(p, v, c, acc);
    }
  }
  ring_end();

  float* cm = smem;
  float* cs = cm + G * TS;
  float* ca = cs + G * TS;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cm[g * TS + ls[r]] = m[r];
    cs[g * TS + ls[r]] = s[r];
    if constexpr (GRADS) {
#pragma unroll
      for (int j = 0; j < DK; ++j)
        if (j < D) ca[(g * TS + ls[r]) * D + j] = acc[r][j];
    }
  }
  __syncthreads();
  finish<GRADS>(a, cm, cs, ca, base, TS, G, D, tid, NT);
}

// The entries.  Their launch bounds differ: with the block size alone
// ptxas weighs registers against resident blocks, which for B1 gives the
// fastest code but for B2 chose a spill at DK = 28; with one block as the
// minimum it may use what it needs, which B2 takes faster and without a
// spill, and B1 slower (scripts/torch_bench_density_kernels.py builds and
// times copies with the bounds swapped beside this one).
template <int DK>
__global__ void __launch_bounds__(NT) density_pack_kernel(const Args a) {
  density_stream<DK, true>(a);
}

template <int DK>
__global__ void __launch_bounds__(NT, 1) densities_kernel(const Args a) {
  density_stream<DK, false>(a);
}

// ---- run-time instance, 32 < D <= 128 -----------------------------------

// Samples [blockIdx.x * blockDim.x, +blockDim.x), one a thread; blockDim.y
// groups, group g takes slots g, g + blockDim.y, ...  x, y and a live in
// local memory as float4s; the products run over 4 x 4 register blocks.
template <bool GRADS>
__global__ void __launch_bounds__(NT) density_wide_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D, rw = row_floats(D), nb = pad4(D) / 4;
  const int tx = threadIdx.x, g = threadIdx.y;
  const int ts = blockDim.x, groups = blockDim.y, tid = g * ts + tx;
  const int base = blockIdx.x * ts, n = base + tx;
  const bool ok = n < a.N;

  float4 x[MAX_D / 4], v[MAX_D / 4], acc[GRADS ? MAX_D / 4 : 1];
  for (int b = 0; b < nb; ++b) {
    float e[4];
#pragma unroll
    for (int f = 0; f < 4; ++f)
      e[f] = (ok && 4 * b + f < D) ? a.xs[(size_t)n * D + 4 * b + f] : 0.f;
    x[b] = make_float4(e[0], e[1], e[2], e[3]);
    if constexpr (GRADS) acc[b] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, s = 0.f;
  const float half_log = -0.5f * (float)D * LOG_2PI;

  const Stage lay{D, D, rw, groups};
  ring_start<WIDE_STAGES>(a, lay, smem, tid, NT);
  for (int ch = 0; ch * groups < a.K; ++ch) {
    const float* st =
        ring_next<WIDE_STAGES>(a, lay, smem, ch, tid, NT);
    const int k = ch * groups + g;
    if (k >= a.K) continue;
    const float* p = st + g * rw;
    const float4* mu = reinterpret_cast<const float4*>(p + tri_off(D));
    for (int b = 0; b < nb; ++b) {
      const float4 xb = x[b], mb = mu[b];
      v[b] = make_float4(xb.x - mb.x, xb.y - mb.y, xb.z - mb.z, xb.w - mb.w);
    }
    // y = L (x - mu), row blocks from last to first, in place
    float q = 0.f;
    for (int b = nb - 1; b >= 0; --b) {
      const int i0 = 4 * b, nrow = min(4, D - i0);
      const float* rows[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) rows[e] = p + tri_off(i0 + e);
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < b; ++c) {
        const float4 d = v[c];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e < nrow) {
            const float4 l = *reinterpret_cast<const float4*>(rows[e] + 4 * c);
            y[e] = fmaf(l.x, d.x, y[e]);
            y[e] = fmaf(l.y, d.y, y[e]);
            y[e] = fmaf(l.z, d.z, y[e]);
            y[e] = fmaf(l.w, d.w, y[e]);
          }
        }
      }
      const float4 d4 = v[b];
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < nrow) {
          const float4 l4 = *reinterpret_cast<const float4*>(rows[e] + i0);
          const float l[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
          for (int f = 0; f <= e; ++f) y[e] = fmaf(l[f], d[f], y[e]);
          q = fmaf(y[e], y[e], q);
        } else {
          y[e] = 0.f;
        }
      }
      v[b] = make_float4(y[0], y[1], y[2], y[3]);
    }
    const float* tail = p + tri_off(D) + pad4(D);
    const float cv = fmaf(-0.5f, q, half_log - tail[0]);
    if (ok) a.comp[(size_t)k * a.N + n] = cv;
    float sc, c;
    online(cv + tail[1], m, s, sc, c);
    if constexpr (GRADS) {
      if (c == 0.f) continue;
      // acc = acc * sc + L^T (c y), column blocks J over row blocks b >= J
      for (int J = 0; J < nb; ++J) {
        float4 aj = acc[J];
        float o[4] = {aj.x * sc, aj.y * sc, aj.z * sc, aj.w * sc};
        {
          const int nrow = min(4, D - 4 * J);
          const float4 y4 = v[J];
          const float t[4] = {c * y4.x, c * y4.y, c * y4.z, c * y4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e < nrow) {
              const float4 l4 = *reinterpret_cast<const float4*>(
                  p + tri_off(4 * J + e) + 4 * J);
              const float l[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
              for (int f = 0; f <= e; ++f) o[f] = fmaf(l[f], t[e], o[f]);
            }
          }
        }
        for (int b = J + 1; b < nb; ++b) {
          const int nrow = min(4, D - 4 * b);
          const float4 y4 = v[b];
          const float t[4] = {c * y4.x, c * y4.y, c * y4.z, c * y4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e < nrow) {
              const float4 l = *reinterpret_cast<const float4*>(
                  p + tri_off(4 * b + e) + 4 * J);
              o[0] = fmaf(l.x, t[e], o[0]);
              o[1] = fmaf(l.y, t[e], o[1]);
              o[2] = fmaf(l.z, t[e], o[2]);
              o[3] = fmaf(l.w, t[e], o[3]);
            }
          }
        }
        acc[J] = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
  ring_end();

  float* cm = smem;
  float* cs = cm + groups * ts;
  float* ca = cs + groups * ts;
  cm[g * ts + tx] = m;
  cs[g * ts + tx] = s;
  if constexpr (GRADS) {
    for (int j = 0; j < D; ++j) {
      const float4 aj = acc[j / 4];
      const float av[4] = {aj.x, aj.y, aj.z, aj.w};
      ca[(g * ts + tx) * D + j] = av[j % 4];
    }
  }
  __syncthreads();
  finish<GRADS>(a, cm, cs, ca, base, ts, groups, D, tid, NT);
}

// ---- launch ---------------------------------------------------------------

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DK, bool GRADS>
cudaError_t launch_unrolled(const Args& a, cudaStream_t st) {
  constexpr int TS = TX * 2;
  const size_t ring = (size_t)DK * TS + STAGES * G * row_floats(DK);
  const size_t comb = (size_t)G * TS * (2 + (GRADS ? a.D : 0));
  const size_t bytes = (ring > comb ? ring : comb) * sizeof(float);
  const auto kernel =
      GRADS ? density_pack_kernel<DK> : densities_kernel<DK>;
  const cudaError_t err = set_smem((const void*)kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(a.N + TS - 1) / TS, dim3(TX, G), bytes, st>>>(a);
  return cudaGetLastError();
}

template <bool GRADS>
cudaError_t launch_wide(const Args& a, cudaStream_t st) {
  const size_t rw = row_floats(a.D);
  int groups = G;
  while (groups > 1 && WIDE_STAGES * groups * rw * sizeof(float) >
                           (size_t)WIDE_RING_BYTES)
    groups /= 2;
  const int ts = NT / groups;
  const size_t ring = WIDE_STAGES * groups * rw;
  const size_t comb = (size_t)NT * (2 + (GRADS ? a.D : 0));
  const size_t bytes = (ring > comb ? ring : comb) * sizeof(float);
  const auto kernel = density_wide_kernel<GRADS>;
  const cudaError_t err = set_smem((const void*)kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(a.N + ts - 1) / ts, dim3(ts, groups), bytes, st>>>(a);
  return cudaGetLastError();
}

// D <= 32: the instance unrolled to D rounded up to a multiple of 4
template <int DK>
cudaError_t dispatch(const Args& a, bool grads, cudaStream_t st) {
  if constexpr (DK > MAX_UNROLLED_D) {
    return grads ? launch_wide<true>(a, st) : launch_wide<false>(a, st);
  } else {
    if (a.D <= DK)
      return grads ? launch_unrolled<DK, true>(a, st)
                   : launch_unrolled<DK, false>(a, st);
    return dispatch<DK + 4>(a, grads, st);
  }
}

}  // namespace

// comp [K, N], model [N] and, when grads is not null, grads [N, D]; all
// arrays float32, contiguous, on the current device.  1 <= D <= 128, K >= 1.
extern "C" int gmmvi_density(const float* means, const float* inv_chols,
                             const float* logw, const float* logdets,
                             const float* x, float* comp, float* model,
                             float* grads, int K, int N, int D,
                             void* stream) {
  if (K < 1 || D < 1 || D > MAX_D || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const bool vec =
      D % 4 == 0 && reinterpret_cast<uintptr_t>(inv_chols) % 16 == 0;
  const Args a{means, inv_chols, logw, logdets, x, comp, model, grads,
               K,     N,         D,    vec};
  return (int)dispatch<4>(a, grads != nullptr,
                          static_cast<cudaStream_t>(stream));
}
