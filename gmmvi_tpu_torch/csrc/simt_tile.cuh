// One 64 x 64 output tile of a plain fp32 SIMT GEMM, the engine shared by
// density_large.cu (B5, B6) and stein.cu (B7).
//
// 64 threads own the tile, each an 8 x 8 micro-tile made of four 4 x 4
// quadrants 32 rows and 32 columns apart: thread (ty, tx) = (tid / 8,
// tid % 8) holds rows {ty*4 + r, 32 + ty*4 + r} and columns {tx*4 + c,
// 32 + tx*4 + c}, r, c < 4.  The caller stages the reduction axis in slabs
// of TK rows: a[kk * S + i] and b[kk * S + j] for kk < TK, i, j < 64.  Per
// slab row a thread reads four float4 (the eight threads of a warp that
// share ty read 128 contiguous bytes of b: no bank conflicts) and does 64
// FMAs, twice the FMAs per shared-memory read of a 4 x 4 micro-tile.  Plain
// fp32 FMA: no TF32, no tensor cores.
#pragma once

#include <cuda_runtime.h>

namespace simt {

constexpr int T = 64;     // tile rows and columns
constexpr int TK = 32;    // reduction slab
constexpr int NT = 64;    // threads per tile
constexpr int S = T + 4;  // row stride of a staged slab (float4-aligned)

// Offset of micro-tile entry r (< 8) of thread coordinate t (< 8).
__device__ __forceinline__ int sub(int t, int r) {
  return (r < 4 ? 0 : 32) + t * 4 + (r & 3);
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
}

// acc[r][c] += sum_{kk < TK} a[kk][sub(ty, r)] * b[kk][sub(tx, c)]
__device__ __forceinline__ void slab_fma(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         float (&acc)[8][8], int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < TK; ++kk) {
    const float* ar = a + kk * S + ty * 4;
    const float* br = b + kk * S + tx * 4;
    const float4 a0 = *reinterpret_cast<const float4*>(ar);
    const float4 a1 = *reinterpret_cast<const float4*>(ar + 32);
    const float4 b0 = *reinterpret_cast<const float4*>(br);
    const float4 b1 = *reinterpret_cast<const float4*>(br + 32);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

}  // namespace simt
