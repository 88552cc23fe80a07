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

// two adjacent bf16 (p[0], p[1]) as one register; p must be 4-byte aligned
__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from different rows (lo, hi) as one register
__device__ __forceinline__ uint32_t join_pair(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// two f32 rounded to bf16 (round to nearest even) as one register
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + nrows) of a (rows, D) bf16 matrix with row
// stride `stride` (elements; columns contiguous) into shared memory with
// row pitch LD. Rows at or past `valid` and columns at or past D are
// written as zeros, so nothing out of bounds is read and padded lanes
// hold exact zeros (never garbage that a multiply could turn into NaN).
// Requires D % 8 == 0 and 16-byte aligned rows (checked by the wrapper).
template <int DP, int LD>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* src,
                                          long long stride, int row0,
                                          int valid, int nrows, int D,
                                          int tid, int nthreads) {
  constexpr int CPR = DP / 8;  // 16-byte chunks per row
  for (int i = tid; i < nrows * CPR; i += nthreads) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < valid && c < D) {
      val = *reinterpret_cast<const uint4*>(src + gr * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

}  // namespace vv
