// Tensor-core helpers shared by the flash kernels: `mma.sync.m16n8k16`
// (bf16 in, f32 accumulate) and the packing of two values into the
// 32-bit register of a fragment pair.
//
// Fragment layouts (PTX ISA, m16n8k16, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//                           a[2] = A[g][2t+8..2t+9], a[3] = A[g+8][2t+8..2t+9]
//   B (16 x 8, "col"):      b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..2t+9][g]
//   C (16 x 8, f32):        c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// so two neighbouring C tiles (columns 16kk .. 16kk+15) are exactly the A
// fragment of a product over those 16 columns once packed to bf16.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> one register of two bf16, `lo` in the low half (the
// lower column / k index of an mma fragment pair).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The A fragment of the C tiles (2kk, 2kk+1) of an accumulator.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0,
                                         const float* c1) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// A fragment of rows r0 .. r0+15, columns c0 .. c0+15 of a row-major bf16
// matrix in shared memory with row pitch `ld` (elements).
__device__ __forceinline__ void smem_a(uint32_t* a, const bf16* m, int ld,
                                       int r0, int c0, int g, int t4) {
  const bf16* p = m + (r0 + g) * ld + c0 + t4 * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B fragment with B[k][n] = M[n0 + n][k0 + k]: M's rows are the n index,
// contiguous along k (K for Q K^T, Q for K Q^T).
__device__ __forceinline__ void smem_b_nk(uint32_t* b, const bf16* m, int ld,
                                          int n0, int k0, int g, int t4) {
  const bf16* p = m + (n0 + g) * ld + k0 + t4 * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment with B[k][n] = M[k0 + k][n0 + n]: M's rows are the k index,
// contiguous along n (V for P V, dO for P^T dO).
__device__ __forceinline__ void smem_b_kn(uint32_t* b, const bf16* m, int ld,
                                          int k0, int n0, int g, int t4) {
  const bf16* p = m + (k0 + t4 * 2) * ld + n0 + g;
  b[0] = pack_bf16(p[0], p[ld]);
  b[1] = pack_bf16(p[8 * ld], p[9 * ld]);
}

}  // namespace
