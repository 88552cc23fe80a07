// flash_attn_fwd: online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the two flash kernels of videovanish_tpu/ops/attention.py:
//   _flash_kernel_inline (:50)  head dims that are not a multiple of 128
//                               (SD1.5 spatial attention, D = 40/80/160)
//   _flash_kernel_iota   (:120) lane-aligned head dims (the VAE mid-block's
//                               single 512-wide head)
// Both compute softmax(q k^T * scale) v with f32 running max / sum; here one
// template covers both.
//
// What bounds it on an H100: at the main path's self-attention shapes
// (S = 8160 tokens, D = 40) the work is 4*S^2*D flops on the tensor cores
// against S^2 exponentials on the special-function units, and at D = 40 the
// exponentials are the larger bound (about 16 ex2 per SM per clock against
// 1024 bf16 FMAs). Bytes are small: q/k/v/o are read and written once per
// query tile. At D = 512 the tensor cores bound it.
//
// Design:
//   * one CTA per (batch*head, 64-query tile); the loop over key tiles inside
//     the CTA takes the place of the TPU grid's sequential KV axis;
//   * 4 row warps of 16 queries each; products on bf16 tensor cores with
//     mma.sync m16n8k16, f32 accumulators, exp2 with scale*log2(e) folded
//     into the score scaling;
//   * D is zero-padded to DP (a multiple of 16, the MMA depth) in shared
//     memory, which is exact; ragged key rows are zero-filled on load and
//     their scores set to -inf before the row max; ragged query rows are
//     computed on zeros and never stored;
//   * wide heads (D = 512) do not fit a warp's output accumulator in
//     registers, so WN column warps split D: each computes a partial
//     q k^T over its D slice, the partials are summed through shared memory,
//     and each warp then owns the output columns of its slice;
//   * a row whose softmax sum is 0 is divided by 1, as the TPU kernels do;
//   * q/k/v/o are read through (batch, head, row) strides with contiguous
//     head dim, so the (B, S, H*D) projection output needs no transpose copy.
#include "mma_bf16.cuh"

namespace vv {

constexpr int kFlashBM = 64;  // query rows per CTA

template <int DP, int WN, int BN>
__global__ void __launch_bounds__(128 * WN)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 int H, int Sq, int Sk, int D,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss,
                 float scale_log2e) {
  constexpr int BM = kFlashBM;
  constexpr int DW = DP / WN;     // head-dim columns owned by one warp
  constexpr int LD = DP + 8;      // shared-memory row pitch (elements)
  constexpr int NT_S = BN / 8;    // score n-tiles per key tile
  constexpr int NT_O = DW / 8;    // output n-tiles per warp
  constexpr int KS_D = DW / 16;   // k-steps over the warp's D slice
  constexpr int KS_N = BN / 16;   // k-steps over the key tile
  static_assert(DW % 16 == 0 && BN % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);  // BM x LD
  uint16_t* Ks = Qs + BM * LD;                            // BN x LD
  uint16_t* Vs = Ks + BN * LD;                            // BN x LD
  float* Sx = reinterpret_cast<float*>(Vs + BN * LD);     // WN x BM x BN

  const int nthreads = 128 * WN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3;   // row group: queries [16*wr, 16*wr + 16)
  const int wc = warp >> 2;  // column group: head dims [DW*wc, DW*wc + DW)
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;

  const uint16_t* qb = q + b * qsb + h * qsh;
  const uint16_t* kb = k + b * ksb + h * ksh;
  const uint16_t* vb = v + b * vsb + h * vsh;

  load_rows<DP, LD>(Qs, qb, qss, q0, Sq, BM, D, tid, nthreads);

  float oacc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  const uint16_t* qrow0 = Qs + (wr * 16 + g) * LD + wc * DW + 2 * t;
  const uint16_t* qrow1 = qrow0 + 8 * LD;

  const int n_kt = (Sk + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // previous tile fully consumed (and the Q tile stored)
    load_rows<DP, LD>(Ks, kb, kss, kt * BN, Sk, BN, D, tid, nthreads);
    load_rows<DP, LD>(Vs, vb, vss, kt * BN, Sk, BN, D, tid, nthreads);
    __syncthreads();

    // scores over this warp's D slice
    float s[NT_S][4];
#pragma unroll
    for (int i = 0; i < NT_S; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS_D; ++ks) {
      const uint32_t a[4] = {ld_pair(qrow0 + ks * 16), ld_pair(qrow1 + ks * 16),
                             ld_pair(qrow0 + ks * 16 + 8),
                             ld_pair(qrow1 + ks * 16 + 8)};
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const uint16_t* kr = Ks + (nt * 8 + g) * LD + wc * DW + ks * 16 + 2 * t;
        const uint32_t bb[2] = {ld_pair(kr), ld_pair(kr + 8)};
        mma_16816(s[nt], a, bb);
      }
    }
    if constexpr (WN > 1) {
      // sum the partial scores of the WN column warps of this row group
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        float* p0 = Sx + (wc * BM + wr * 16 + g) * BN + nt * 8 + 2 * t;
        p0[0] = s[nt][0];
        p0[1] = s[nt][1];
        p0[8 * BN] = s[nt][2];
        p0[8 * BN + 1] = s[nt][3];
      }
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int c = 0; c < WN; ++c) {
          const float* p0 = Sx + (c * BM + wr * 16 + g) * BN + nt * 8 + 2 * t;
          s[nt][0] += p0[0];
          s[nt][1] += p0[1];
          s[nt][2] += p0[8 * BN];
          s[nt][3] += p0[8 * BN + 1];
        }
      }
    }

    // scale into the log2 domain; mask the ragged key tail to -inf
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * BN + nt * 8 + 2 * t + (e & 1);
        const float x = col < Sk ? s[nt][e] * scale_log2e : -INFINITY;
        s[nt][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float alpha[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      // the first key tile always holds a valid key, so m_new is finite
      m_new[r] = fmaxf(m_run[r], tmax[r]);
      alpha[r] = exp2f(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_new[e >> 1]);
        s[nt][e] = p;
        lsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + lsum[r];
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      oacc[i][0] *= alpha[0];
      oacc[i][1] *= alpha[0];
      oacc[i][2] *= alpha[1];
      oacc[i][3] *= alpha[1];
    }

    // o += p v over this warp's output columns; p's C fragments of two
    // adjacent key n-tiles are exactly the A fragment of one k-step
#pragma unroll
    for (int ks = 0; ks < KS_N; ++ks) {
      const uint32_t a[4] = {pack_f32(s[2 * ks][0], s[2 * ks][1]),
                             pack_f32(s[2 * ks][2], s[2 * ks][3]),
                             pack_f32(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_f32(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const uint16_t* v0 = Vs + (ks * 16 + 2 * t) * LD + wc * DW + g;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const uint16_t* vp = v0 + nt * 8;
        const uint32_t bb[2] = {join_pair(vp[0], vp[LD]),
                                join_pair(vp[8 * LD], vp[9 * LD])};
        mma_16816(oacc[nt], a, bb);
      }
    }
  }

  // finish: full row sums across the quad, l == 0 -> 1, store valid rows
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / (l == 0.f ? 1.f : l);
  }
  uint16_t* ob = o + b * osb + h * osh;
  const int r0 = q0 + wr * 16 + g;
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    const int col = wc * DW + nt * 8 + 2 * t;
    if (col < D) {
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * oss + col) =
            pack_f32(oacc[nt][0] * inv[0], oacc[nt][1] * inv[0]);
      if (r0 + 8 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * oss + col) =
            pack_f32(oacc[nt][2] * inv[1], oacc[nt][3] * inv[1]);
    }
  }
}

template <int DP, int WN, int BN>
int launch_flash(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int Sq, int Sk, int D, const long long* st,
                 float scale_log2e, cudaStream_t stream) {
  constexpr int LD = DP + 8;
  const size_t smem = static_cast<size_t>(kFlashBM + 2 * BN) * LD * 2 +
                      (WN > 1 ? static_cast<size_t>(WN) * kFlashBM * BN * 4 : 0);
  auto kern = flash_fwd_kernel<DP, WN, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kFlashBM - 1) / kFlashBM, B * H);
  kern<<<grid, 128 * WN, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), H, Sq, Sk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vv

// Padded head dims this library is built for: those the port dispatches
// (SD1.5 heads of 40/80/160, the VAE's 512); the wrapper refuses others.
extern "C" int vv_flash_supported(int dp) {
  switch (dp) {
    case 48: case 80: case 160: case 512:
      return 1;
    default:
      return 0;
  }
}

// q/k/v/o: bf16 (B, H, S, D) views with contiguous D; strides holds the
// (batch, head, row) strides of q, k, v, o in elements (12 values).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int vv_flash_attn_fwd(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int Sq, int Sk, int D,
                                 const long long* strides, float scale_log2e,
                                 void* stream) {
  const int dp = (D + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 48:  return vv::launch_flash<48, 1, 64>(q, k, v, o, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 80:  return vv::launch_flash<80, 1, 64>(q, k, v, o, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 160: return vv::launch_flash<160, 1, 64>(q, k, v, o, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 512: return vv::launch_flash<512, 4, 32>(q, k, v, o, B, H, Sq, Sk, D, strides, scale_log2e, s);
    default:  return static_cast<int>(cudaErrorInvalidValue);
  }
}
