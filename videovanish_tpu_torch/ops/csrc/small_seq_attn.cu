// small_seq_attn: exact softmax attention for many short sequences, for
// Hopper (sm_90a).
//
// Replaces the two packed kernels of videovanish_tpu/ops/attention.py:
//   _packed_tokenmajor_kernel (:337)  token-major (N, S, heads*d) input: the
//                                     motion modules' temporal attention over
//                                     a 22-frame window
//   _packed_kernel            (:269)  the same on (B, H, S, D) input, Sq != Sk
//                                     allowed (the dispatch's fallback when the
//                                     token-major layout does not apply)
// Both compute softmax(q k^T * scale) v independently per (sequence, head)
// with 17 <= S <= 64. The TPU kernels packed 128 // S sequences into one MXU
// tile under a block-diagonal mask; that is MXU packing and is not carried
// over.
//
// What bounds it on an H100: memory. Each (sequence, head) pair reads
// S*D*3 and writes S*D bf16 values and does only 4*S*S*D flops, far under the
// card's ~295 flops per byte, so the floor is q/k/v/o traffic at 3.35 TB/s.
//
// Design:
//   * one warp per (sequence, head); a CTA holds up to 4 warps, i.e. up to 4
//     sequences of one head (fewer when their shared memory would not fit).
//     q/k/v/o are read through (sequence, head, row) strides, so the
//     token-major (N, S, C) projection output is consumed in place and
//     the output is written straight back in that layout: no transpose and
//     no packing copy ever reaches device memory;
//   * the whole sequence sits in the warp's shared-memory slice (rows padded
//     to 16, D zero-padded to a multiple of 16, both exact);
//   * per 16-query strip: scores on the tensor cores (mma.sync m16n8k16,
//     bf16 in, f32 out), padded keys masked to -inf, a full f32 softmax in
//     registers, then p v on the tensor cores and one division by the row
//     sum.
#include "mma_bf16.cuh"

namespace vv {

constexpr int kSmallMaxWarps = 4;  // sequences per CTA, at most
constexpr int kSmallMaxS = 64;
constexpr long long kSmemCeiling = 232448;  // a block's shared memory on sm_90

// shared memory of one warp's slice (q, k, v rows, padded)
inline long long small_warp_smem(int dp, int sq, int sk) {
  return static_cast<long long>((sq + 15) / 16 * 16 + 2 * ((sk + 15) / 16 * 16)) *
         (dp + 8) * 2;
}

template <int DP>
__global__ void __launch_bounds__(32 * kSmallMaxWarps)
small_seq_attn_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                      int B, int Sq, int Sk, int D,
                      long long qsb, long long qsh, long long qss,
                      long long ksb, long long ksh, long long kss,
                      long long vsb, long long vsh, long long vss,
                      long long osb, long long osh, long long oss,
                      float scale_log2e) {
  constexpr int LD = DP + 8;
  constexpr int NT_O = DP / 8;
  constexpr int KS_D = DP / 16;
  const int sqp = (Sq + 15) / 16 * 16;
  const int skp = (Sk + 15) / 16 * 16;
  const int nt_s = skp / 8;   // score n-tiles (<= 8)
  const int ks_n = skp / 16;  // k-steps over keys (<= 4)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw) +
                 warp * (sqp + 2 * skp) * LD;
  uint16_t* Ks = Qs + sqp * LD;
  uint16_t* Vs = Ks + skp * LD;

  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  const int h = blockIdx.y;
  if (b >= B) return;  // warp-local work only: no CTA barrier below

  load_rows<DP, LD>(Qs, q + b * qsb + h * qsh, qss, 0, Sq, sqp, D, lane, 32);
  load_rows<DP, LD>(Ks, k + b * ksb + h * ksh, kss, 0, Sk, skp, D, lane, 32);
  load_rows<DP, LD>(Vs, v + b * vsb + h * vsh, vss, 0, Sk, skp, D, lane, 32);
  __syncwarp();

  uint16_t* ob = o + b * osb + h * osh;
  for (int strip = 0; strip < sqp / 16; ++strip) {
    const uint16_t* qrow0 = Qs + (strip * 16 + g) * LD + 2 * t;
    const uint16_t* qrow1 = qrow0 + 8 * LD;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS_D; ++ks) {
      const uint32_t a[4] = {ld_pair(qrow0 + ks * 16), ld_pair(qrow1 + ks * 16),
                             ld_pair(qrow0 + ks * 16 + 8),
                             ld_pair(qrow1 + ks * 16 + 8)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < nt_s) {
          const uint16_t* kr = Ks + (nt * 8 + g) * LD + ks * 16 + 2 * t;
          const uint32_t bb[2] = {ld_pair(kr), ld_pair(kr + 8)};
          mma_16816(s[nt], a, bb);
        }
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float x = (nt < nt_s && col < Sk) ? s[nt][e] * scale_log2e
                                                : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - mx[e >> 1]);  // masked -> exactly 0
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    }

    float oacc[NT_O][4];
#pragma unroll
    for (int i = 0; i < NT_O; ++i)
      oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSmallMaxS / 16; ++ks) {
      if (ks < ks_n) {
        const uint32_t a[4] = {pack_f32(s[2 * ks][0], s[2 * ks][1]),
                               pack_f32(s[2 * ks][2], s[2 * ks][3]),
                               pack_f32(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                               pack_f32(s[2 * ks + 1][2], s[2 * ks + 1][3])};
        const uint16_t* v0 = Vs + (ks * 16 + 2 * t) * LD + g;
#pragma unroll
        for (int nt = 0; nt < NT_O; ++nt) {
          const uint16_t* vp = v0 + nt * 8;
          const uint32_t bb[2] = {join_pair(vp[0], vp[LD]),
                                  join_pair(vp[8 * LD], vp[9 * LD])};
          mma_16816(oacc[nt], a, bb);
        }
      }
    }

    const int r0 = strip * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (col < D) {
        if (r0 < Sq)
          *reinterpret_cast<uint32_t*>(ob + r0 * oss + col) =
              pack_f32(oacc[nt][0] * l[0], oacc[nt][1] * l[0]);
        if (r0 + 8 < Sq)
          *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * oss + col) =
              pack_f32(oacc[nt][2] * l[1], oacc[nt][3] * l[1]);
      }
    }
  }
}

template <int DP>
int launch_small(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int Sq, int Sk, int D, const long long* st,
                 float scale_log2e, cudaStream_t stream) {
  const long long per_warp = small_warp_smem(DP, Sq, Sk);
  int nw = kSmallMaxWarps;
  while (nw > 1 && nw * per_warp > kSmemCeiling) nw /= 2;
  const size_t smem = static_cast<size_t>(nw * per_warp);
  auto kern = small_seq_attn_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + nw - 1) / nw, H);
  kern<<<grid, 32 * nw, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), B, Sq, Sk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vv

extern "C" int vv_small_seq_supported(int dp, int sq, int sk) {
  if (sq < 1 || sk < 1 || sq > vv::kSmallMaxS || sk > vv::kSmallMaxS) return 0;
  if (vv::small_warp_smem(dp, sq, sk) > vv::kSmemCeiling) return 0;
  switch (dp) {  // the motion modules' head dims 40/80/160, padded
    case 48: case 80: case 160:
      return 1;
    default:
      return 0;
  }
}

// q/k/v/o: bf16 (B, H, S, D) views with contiguous D (token-major input is
// the (N, H, S, d) view of (N, S, H*d)); strides holds the (sequence, head,
// row) strides of q, k, v, o in elements (12 values). Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int vv_small_seq_attn(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int Sq, int Sk, int D,
                                 const long long* strides, float scale_log2e,
                                 void* stream) {
  const int dp = (D + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 48:  return vv::launch_small<48>(q, k, v, o, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 80:  return vv::launch_small<80>(q, k, v, o, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 160: return vv::launch_small<160>(q, k, v, o, B, H, Sq, Sk, D, strides, scale_log2e, s);
    default:  return static_cast<int>(cudaErrorInvalidValue);
  }
}
