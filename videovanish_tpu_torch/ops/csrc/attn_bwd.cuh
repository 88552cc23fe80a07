// Shared pieces of the attention backward kernels (flash_attn_bwd.cu,
// small_seq_attn_bwd.cu): the strides of their eight operands, cp.async
// row loads into padded shared-memory tiles, and the fragment addressing
// of mma.sync m16n8k16 over those tiles.
//
// A tile holds rows of one (batch, head) slice, DK columns (the head dim
// padded to 16) at a pitch of DK + 8 elements, so the 8 rows of one
// ldmatrix phase start in different bank groups. Rows past the sequence
// and columns past D are zero-filled, so padded keys and queries add
// nothing to a product.
#pragma once

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace vv {

// (batch, head, row) strides in elements of q, k, v, o, dO, dq, dk, dv
struct BwdStrides {
  long long s[8][3];
};
enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [r0, r0 + n) of a slice (row stride rs elements) into the tile at
// dst (pitch LD elements), DK / 8 16-byte chunks a row, by threads
// tid, tid + nthreads, ...; rows at or past S and chunks past D are
// zero-filled without a read. Completes at cp_async_wait_all.
template <int DK, int LD>
__device__ __forceinline__ void load_rows(uint32_t dst, const uint16_t* src,
                                          long long rs, int r0, int n, int S,
                                          int D, int tid, int nthreads) {
  constexpr int CPR = DK / 8;
  for (int i = tid; i < n * CPR; i += nthreads) {
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = r0 + r < S && c * 8 < D;
    const uint16_t* p = ok ? src + (r0 + r) * rs + c * 8 : src;
    cp_async_16(dst + (r * LD + c * 8) * 2, p, ok);
  }
}

// Lane addresses into a tile of pitch LD (elements) whose row 0 is at
// `tile`, for ldmatrix.x4 at k-step / n-pair offsets added by the caller:
//   a_rows:  A operand, rows of the tile are A's rows (m), columns its k
//            (add ks * 32 bytes per 16-column step, row0 * LD * 2 per strip)
//   b_rows:  B operand, rows of the tile are B's n, columns its k
//            (add (n2 * 16 * LD + ks * 16) * 2): b[0], b[1] of n-tiles
//            2 n2 and 2 n2 + 1 are r[0], r[1] and r[2], r[3]
//   bt_rows: B operand, rows of the tile are B's k, columns its n
//            (ldmatrix.trans; add (ks * 16 * LD + n2 * 16) * 2)
//   at_rows: A operand, rows of the tile are A's k, columns its m
//            (ldmatrix.trans; add (ks * 16 * LD + m0) * 2)
__device__ __forceinline__ uint32_t a_rows(uint32_t tile, int LD, int lane) {
  return tile + ((lane & 15) * LD + (lane >> 4) * 8) * 2;
}
__device__ __forceinline__ uint32_t b_rows(uint32_t tile, int LD, int lane) {
  return tile + (((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8) * 2;
}
__device__ __forceinline__ uint32_t bt_rows(uint32_t tile, int LD, int lane) {
  return tile + ((((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8) * 2;
}
__device__ __forceinline__ uint32_t at_rows(uint32_t tile, int LD, int lane) {
  return tile + (((lane & 7) + ((lane >> 4) & 1) * 8) * LD + ((lane >> 3) & 1) * 8) * 2;
}

// C fragments of n-tiles 2j and 2j + 1 (f32) as the bf16 A fragment of
// k-step j: a C row block is an A row block, two n-tiles one k-step
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// acc[NT][4] (16 rows x NT * 8 columns, C layout) times `mul`, as bf16
// into rows row0 + g and row0 + g + 8 (those below `rows`) of a slice at
// `out` (row stride rs), columns below D
template <int NT>
__device__ __forceinline__ void store_rows(uint16_t* out, long long rs,
                                           const float (&acc)[NT][4],
                                           float mul, int row0, int rows,
                                           int D, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
    uint16_t* p = out + row * rs;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<uint32_t*>(p + col) =
            pack_f32(acc[nt][2 * r] * mul, acc[nt][2 * r + 1] * mul);
    }
  }
}

}  // namespace vv
