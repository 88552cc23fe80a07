// Shared helpers for the attention kernels: bf16 tensor-core products with
// mma.sync.m16n8k16 and the fragment layouts they use.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major)  a[0] = A[g][2t..2t+1]     a[1] = A[g+8][2t..2t+1]
//                         a[2] = A[g][2t+8..2t+9]   a[3] = A[g+8][2t+8..2t+9]
//   B (16x8, col-major)   b[0] = B[2t..2t+1][g]     b[1] = B[2t+8..2t+9][g]
//   C (16x8, f32)         c[0..1] = C[g][2t..2t+1]  c[2..3] = C[g+8][2t..2t+1]
// Each 32-bit register holds two bf16 values; the lower index sits in the
// low 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vv {

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two f32 rounded to bf16 (round to nearest even) as one register
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 bf16 matrices from shared memory (ldmatrix): lanes 8i..8i+7 give
// the row addresses (16-byte aligned, shared-space u32) of matrix i, and
// r[i] receives this lane's fragment of it: row lane / 4, columns
// 2 (lane % 4) and the next. With .trans each matrix arrives transposed:
// rows 2 (lane % 4) and the next, column lane / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

}  // namespace vv
