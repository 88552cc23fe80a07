// small_seq_attn_bwd: the gradient of small_seq_attn for Hopper (sm_90a).
//
// The JAX package's packed kernels (_packed_kernel, :269, and
// _packed_tokenmajor_kernel, :337, of videovanish_tpu/ops/attention.py)
// define no VJP, so its trainer differentiates short-sequence attention
// only on XLA's route, `_packed_small_attention` (:460). This kernel
// computes what jax.vjp of that function computes, for every shape
// small_seq_attn takes: 1 <= Sq, Sk <= 64, on (B, H, S, D) views or on the
// (N, heads, S, d) split of token-major (N, S, heads * d) storage, read
// and written in place through (sequence, head, row) strides.
//
// One warp a (sequence, head) unit, as many units a CTA as fit in shared
// memory (at most four). A unit's whole q, k, v and dO (S <= 64 rows, so
// no online softmax is needed) come into padded tiles by cp.async, and the
// warp
//   1. takes delta = rowsum(dO o O) per query row in f32 (O from memory);
//   2. per 16-query strip: S = q k^T, an exact f32 softmax P (the forward's
//      arithmetic), dP = dO v^T, dS = P (dP - delta), and stores P and dS
//      as bf16 tiles;
//   3. dq = scale dS k per query strip, dv = P^T dO and dk = scale dS^T q
//      per 16-key strip (P^T and dS^T read with ldmatrix.trans),
// each written straight to its rows. Products are mma.sync m16n8k16 (bf16
// in, f32 accumulate). No atomics: a rerun is bitwise.
//
// What bounds it on an H100: bytes, as the forward. A unit reads q, k, v,
// o, dO and writes dq, dk, dv (8 S D bf16 values) for 10 S^2 D flops, 14
// flops a byte at S = 22. This first version keeps no loads in flight
// while a warp computes (one buffer, no ring), so it is latency-bound far
// from that (PERF.md, the kernel table).
#include "attn_bwd.cuh"

namespace vv {

constexpr int kSmallBwdMaxS = 64;
constexpr int kSmallBwdMaxWarps = 4;
constexpr int kSmallBwdSmem = 232448;  // a block's shared memory on sm_90

__host__ __device__ constexpr int bwd_pad16(int s) { return (s + 15) / 16 * 16; }

// bytes of one unit's tiles: q, dO (sqp rows), k, v (skp rows) at pitch
// DP + 8; P and dS (sqp x skp bf16 at pitch skp + 8); delta (sqp f32)
__host__ __device__ constexpr int small_bwd_unit_bytes(int dp, int sq, int sk) {
  return (2 * bwd_pad16(sq) + 2 * bwd_pad16(sk)) * (dp + 8) * 2 +
         2 * bwd_pad16(sq) * (bwd_pad16(sk) + 8) * 2 + bwd_pad16(sq) * 4;
}

template <int DP>
__global__ void __launch_bounds__(32 * kSmallBwdMaxWarps)
small_seq_bwd_kernel(const uint16_t* __restrict__ q,
                     const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v,
                     const uint16_t* __restrict__ o,
                     const uint16_t* __restrict__ dout,
                     uint16_t* __restrict__ dq, uint16_t* __restrict__ dk,
                     uint16_t* __restrict__ dv, int B, int H, int Sq, int Sk,
                     int D, const BwdStrides st, float scale,
                     float scale_log2e, int unit_bytes) {
  constexpr int LD = DP + 8;
  constexpr int NT = DP / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const long long unit =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (unit >= static_cast<long long>(B) * H) return;  // whole warps only
  const int b = static_cast<int>(unit / H), h = static_cast<int>(unit % H);
  const int sqp = bwd_pad16(Sq), skp = bwd_pad16(Sk);
  const int LP = skp + 8;  // pitch of the P and dS tiles

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem) + warp * unit_bytes;
  const uint32_t sdO = sQ + sqp * LD * 2, sK = sdO + sqp * LD * 2,
                 sV = sK + skp * LD * 2, sP = sV + skp * LD * 2,
                 sdS = sP + sqp * LP * 2, sDelta = sdS + sqp * LP * 2;

  auto base = [&](const uint16_t* p, int i) {
    return p + b * st.s[i][0] + h * st.s[i][1];
  };
  load_rows<DP, LD>(sQ, base(q, kQ), st.s[kQ][2], 0, sqp, Sq, D, lane, 32);
  load_rows<DP, LD>(sdO, base(dout, kDO), st.s[kDO][2], 0, sqp, Sq, D, lane,
                    32);
  load_rows<DP, LD>(sK, base(k, kK), st.s[kK][2], 0, skp, Sk, D, lane, 32);
  load_rows<DP, LD>(sV, base(v, kV), st.s[kV][2], 0, skp, Sk, D, lane, 32);

  // delta per query row, f32, from O and dO in memory
  {
    const uint16_t* ob = base(o, kO);
    const uint16_t* db = base(dout, kDO);
    for (int r = lane; r < sqp; r += 32) {
      float acc = 0.f;
      if (r < Sq) {
        const uint16_t* po = ob + r * st.s[kO][2];
        const uint16_t* pd = db + r * st.s[kDO][2];
        for (int c = 0; c < D; c += 2) {
          const uint32_t a = *reinterpret_cast<const uint32_t*>(po + c);
          const uint32_t d = *reinterpret_cast<const uint32_t*>(pd + c);
          acc = fmaf(__uint_as_float(a << 16), __uint_as_float(d << 16), acc);
          acc = fmaf(__uint_as_float(a & 0xffff0000u),
                     __uint_as_float(d & 0xffff0000u), acc);
        }
      }
      st_shared_u32(sDelta + r * 4, __float_as_uint(acc));
    }
  }
  cp_async_wait_all();
  __syncwarp();

  const int ks_n = skp / 16, qs_n = sqp / 16;
  // 2. P and dS per 16-query strip
  for (int strip = 0; strip < qs_n; ++strip) {
    const uint32_t qa = a_rows(sQ + strip * 16 * LD * 2, LD, lane);
    const uint32_t da = a_rows(sdO + strip * 16 * LD * 2, LD, lane);
    const uint32_t kb = b_rows(sK, LD, lane), vb = b_rows(sV, LD, lane);
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t aq[4], ad[4];
      ldsm_x4(aq, qa + ks * 32);
      ldsm_x4(ad, da + ks * 32);
#pragma unroll
      for (int n2 = 0; n2 < kSmallBwdMaxS / 16; ++n2) {
        if (n2 < ks_n) {
          uint32_t r[4];
          ldsm_x4(r, kb + (n2 * 16 * LD + ks * 16) * 2);
          const uint32_t k0f[2] = {r[0], r[1]}, k1f[2] = {r[2], r[3]};
          mma_16816(s[2 * n2], aq, k0f);
          mma_16816(s[2 * n2 + 1], aq, k1f);
          ldsm_x4(r, vb + (n2 * 16 * LD + ks * 16) * 2);
          const uint32_t v0f[2] = {r[0], r[1]}, v1f[2] = {r[2], r[3]};
          mma_16816(dp[2 * n2], ad, v0f);
          mma_16816(dp[2 * n2 + 1], ad, v1f);
        }
      }
    }
    // exact softmax over the Sk keys (the forward's arithmetic)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float x = col < Sk ? s[nt][e] * scale_log2e : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - mx[e >> 1]);  // masked -> 0
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    float inv[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = strip * 16 + g + 8 * r;
      // a padded query row adds nothing to dv or dk
      inv[r] = row < Sq ? 1.f / l[r] : 0.f;
      dl[r] = ld_shared_f32(sDelta + row * 4);
    }
    // P and dS = P (dP - delta) to their bf16 tiles
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < skp / 8) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = s[nt][e] * inv[e >> 1];
          ds[e] = p[e] * (dp[nt][e] - dl[e >> 1]);
        }
        const int off = ((strip * 16 + g) * LP + nt * 8 + 2 * t) * 2;
        st_shared_u32(sP + off, pack_f32(p[0], p[1]));
        st_shared_u32(sP + off + 8 * LP * 2, pack_f32(p[2], p[3]));
        st_shared_u32(sdS + off, pack_f32(ds[0], ds[1]));
        st_shared_u32(sdS + off + 8 * LP * 2, pack_f32(ds[2], ds[3]));
      }
    }
  }
  __syncwarp();

  // 3. dq = scale dS k per query strip
  const uint32_t kt = bt_rows(sK, LD, lane);
  for (int strip = 0; strip < qs_n; ++strip) {
    const uint32_t dsa = a_rows(sdS + strip * 16 * LP * 2, LP, lane);
    float acc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kSmallBwdMaxS / 16; ++j) {
      if (j < ks_n) {
        uint32_t a[4];
        ldsm_x4(a, dsa + j * 32);
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t r[4];
          ldsm_x4_trans(r, kt + (j * 16 * LD + n2 * 16) * 2);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_16816(acc[2 * n2], a, b0);
          mma_16816(acc[2 * n2 + 1], a, b1);
        }
      }
    }
    store_rows<NT>(dq + b * st.s[kDQ][0] + h * st.s[kDQ][1], st.s[kDQ][2],
                   acc, scale, strip * 16, Sq, D, lane);
  }

  // dv = P^T dO and dk = scale dS^T q per 16-key strip
  const uint32_t dot = bt_rows(sdO, LD, lane), qt = bt_rows(sQ, LD, lane);
  for (int which = 0; which < 2; ++which) {
    const uint32_t src = which == 0 ? sP : sdS;
    const uint32_t rhs = which == 0 ? dot : qt;
    uint16_t* out = which == 0 ? dv + b * st.s[kDV][0] + h * st.s[kDV][1]
                               : dk + b * st.s[kDK][0] + h * st.s[kDK][1];
    const long long rs = which == 0 ? st.s[kDV][2] : st.s[kDK][2];
    for (int strip = 0; strip < ks_n; ++strip) {
      const uint32_t pa = at_rows(src, LP, lane) + strip * 16 * 2;
      float acc[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kSmallBwdMaxS / 16; ++j) {
        if (j < qs_n) {
          uint32_t a[4];
          ldsm_x4_trans(a, pa + j * 16 * LP * 2);
#pragma unroll
          for (int n2 = 0; n2 < NT / 2; ++n2) {
            uint32_t r[4];
            ldsm_x4_trans(r, rhs + (j * 16 * LD + n2 * 16) * 2);
            const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            mma_16816(acc[2 * n2], a, b0);
            mma_16816(acc[2 * n2 + 1], a, b1);
          }
        }
      }
      store_rows<NT>(out, rs, acc, which == 0 ? 1.f : scale, strip * 16, Sk,
                     D, lane);
    }
  }
}

template <int DP>
static int launch_small_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, void* dq,
                            void* dk, void* dv, int B, int H, int Sq, int Sk,
                            int D, const BwdStrides& st, float scale_log2e,
                            cudaStream_t stream) {
  const int unit = (small_bwd_unit_bytes(DP, Sq, Sk) + 15) / 16 * 16;
  int warps = kSmallBwdSmem / unit;
  if (warps > kSmallBwdMaxWarps) warps = kSmallBwdMaxWarps;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = small_seq_bwd_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, warps * unit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = static_cast<long long>(B) * H;
  auto u16 = [](const void* p) { return static_cast<const uint16_t*>(p); };
  kern<<<static_cast<unsigned>((units + warps - 1) / warps), 32 * warps,
         warps * unit, stream>>>(
      u16(q), u16(k), u16(v), u16(o), u16(dout), static_cast<uint16_t*>(dq),
      static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), B, H, Sq, Sk, D,
      st, scale_log2e * 0.6931471805599453f, scale_log2e, unit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vv

// What the backward is built for: the padded head dims of the forward's
// trainer shapes (40, 80, 160; 72 pads to 80) and 1 <= Sq, Sk <= 64.
extern "C" int vv_small_seq_bwd_supported(int dp, int sq, int sk) {
  if (sq < 1 || sk < 1 || sq > vv::kSmallBwdMaxS || sk > vv::kSmallBwdMaxS)
    return 0;
  if (vv::small_bwd_unit_bytes(dp, sq, sk) > vv::kSmallBwdSmem) return 0;
  return dp == 48 || dp == 80 || dp == 160;
}

// q, k, v, o, dO, dq, dk, dv: bf16 (B, H, S, D) views with contiguous D
// (token-major operands as the (N, H, S, d) view of (N, S, H * d));
// strides holds their (sequence, head, row) strides in elements (24
// values); scale_log2e: the softmax scale times log2(e), as the forward
// takes it. Launches on `stream`, allocates nothing, returns 0 or a CUDA
// error.
extern "C" int vv_small_seq_attn_bwd(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, void* dq, void* dk,
                                     void* dv, int B, int H, int Sq, int Sk,
                                     int D, const long long* strides,
                                     float scale_log2e, void* stream) {
  vv::BwdStrides st;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) st.s[i][j] = strides[3 * i + j];
  const int dp = (D + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 48:  return vv::launch_small_bwd<48>(q, k, v, o, dout, dq, dk, dv, B, H, Sq, Sk, D, st, scale_log2e, s);
    case 80:  return vv::launch_small_bwd<80>(q, k, v, o, dout, dq, dk, dv, B, H, Sq, Sk, D, st, scale_log2e, s);
    case 160: return vv::launch_small_bwd<160>(q, k, v, o, dout, dq, dk, dv, B, H, Sq, Sk, D, st, scale_log2e, s);
    default:  return static_cast<int>(cudaErrorInvalidValue);
  }
}
