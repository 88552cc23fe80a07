// Shared pieces of the attention backward kernels (flash_attn_bwd.cu,
// small_seq_attn_bwd.cu): the strides of their eight operands, and (for
// small_seq_attn_bwd) the fragment addressing of mma.sync m16n8k16 over
// padded shared-memory tiles and the fragment stores of its results.
//
// A tile holds rows of one (batch, head) slice at a pitch of LD elements.
// Rows past the sequence and columns past D arrive as zeros (TMA), so
// padded keys and queries add nothing to a product.
#pragma once

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace vv {

// (batch, head, row) strides in elements of q, k, v, o, dO, dq, dk, dv
struct BwdStrides {
  long long s[8][3];
};
enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
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
