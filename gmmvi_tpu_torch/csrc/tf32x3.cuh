// Split-TF32 (3xTF32) warpgroup products on Hopper's tensor cores
// (wgmma, sm_90a): the engine shared by density_large.cu (B5) and
// stein.cu (B7).
//
// A float a is split into hi = tf32(a) (round to nearest) and lo =
// tf32(a - hi); a product a b is taken as hi hi' + hi lo' + lo hi', three
// TF32 tensor-core products summed into the same fp32 registers (the
// dropped lo lo' is ~2^-22 of a b), which keeps the float32 accuracy that
// whitening and Mahalanobis sums need at a third of the TF32 rate.
//
// A warpgroup (128 threads) computes a 64 x 64 tile over slabs of KS = 32
// reduction steps.  A (64 rows x 8 steps per instruction) comes from
// registers, in the register fragment of mma.m16n8k8 per warp: warp w of
// the group owns rows 16w..16w+15, and lane (gid = lane / 4, tig = lane %
// 4) holds (gid, tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4).
// B comes from shared memory: TF32 wgmma reads both operands K-major only
// (its transpose bits exist for 16-bit types alone), so a B slab is
// [KS / 4][64][4] floats, a 16-byte row of 4 steps per output column: the
// no-swizzle layout, whose 8-row "core matrices" lie 128 bytes apart and
// whose next 4 steps lie 1,024 bytes on.  An A slab is [64][KS] with its
// 16-byte chunks permuted by row (chunk c of row r at c ^ (r % 8)), so that
// the fragment loads of a warp hit 32 different banks.  The accumulator is
// the usual fragment: d[4c + 0..1] at row gid, columns 8c + 2 tig + {0,
// 1}, and d[4c + 2..3] at row gid + 8.
//
// The pre-passes of the kernels write every slab of either operand in
// exactly this shared-memory image, so a stage is filled by a few bulk
// copies (cp.async.bulk, the Tensor Memory Accelerator's 1-D form) that
// one thread issues and an mbarrier tracks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int KS = 32;                 // reduction steps per slab
constexpr int TILE = 64;               // rows of a slab of either operand
constexpr int SLAB = TILE * KS;        // floats of one slab
constexpr int SLAB_BYTES = SLAB * 4;   // 8 KB

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// (hi, lo) with hi + lo = a to ~2^-22 relative
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// Offset of (row r, step c) within an A slab's image.  (In a B slab's
// image (step c, column r) lies at ((c / 4) * TILE + r) * 4 + c % 4.)
__device__ __forceinline__ int a_offset(int r, int c) {
  return r * KS + ((((c >> 2) ^ (r & 7))) << 2) + (c & 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global src to
// shared dst, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// orders this thread's earlier shared-memory accesses before later
// asynchronous-proxy ones (a bulk copy into a stage just read)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of r across a wgmma boundary
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Descriptor of a B slab's 8 steps at p (no swizzle, K-major): start
// address, leading byte offset (the next 4 steps) 1,024 bytes, stride byte
// offset (the next 8 rows) 128 bytes, all in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(TILE * 16 / 16) << 16) |
         ((uint64_t)(128 / 16) << 32);
}

// d[0..32) += A (64 x 8, tf32 bits in a[0..4), the register fragment
// of mma.m16n8k8 per warp) times B (8 x 64, K-major in shared memory at
// desc); d is zeroed first when accumulate == 0.
__device__ __forceinline__ void mma_m64n64k8(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// acc = the 64 x 64 product of one slab: sum over s < KS of A[r][s]
// B[s][c], A given per thread as av[j][0..3] (the fragment of steps
// 8j..8j+7), B as its split halves bh and bl (slab images).  Twelve wgmma
// in one group, waited for before returning.
__device__ __forceinline__ void slab_product(float (&acc)[32],
                                             const float (&av)[KS / 8][4],
                                             const float* bh,
                                             const float* bl) {
  uint32_t hi[KS / 8][4], lo[KS / 8][4];
#pragma unroll
  for (int j = 0; j < KS / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) split(av[j][q], hi[j][q], lo[j][q]);
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < KS / 8; ++j) {
    const uint64_t dh = b_desc(bh + 2 * j * TILE * 4);
    const uint64_t dl = b_desc(bl + 2 * j * TILE * 4);
    mma_m64n64k8(acc, hi[j], dh, j > 0);
    mma_m64n64k8(acc, hi[j], dl, 1);
    mma_m64n64k8(acc, lo[j], dh, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
}

// This thread's A fragment of the A slab image a, each entry through
// f(value, step within the slab); the thread's place in its warpgroup
// picks the rows.
template <typename F>
__device__ __forceinline__ void load_a(const float* a, float (&av)[KS / 8][4],
                                       F f) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r0 = 16 * warp + (lane >> 2), tig = lane & 3;
#pragma unroll
  for (int j = 0; j < KS / 8; ++j) {
    const int c0 = 8 * j + tig, c1 = c0 + 4;
    av[j][0] = f(a[a_offset(r0, c0)], c0);
    av[j][1] = f(a[a_offset(r0 + 8, c0)], c0);
    av[j][2] = f(a[a_offset(r0, c1)], c1);
    av[j][3] = f(a[a_offset(r0 + 8, c1)], c1);
  }
}

}  // namespace tf32x3
