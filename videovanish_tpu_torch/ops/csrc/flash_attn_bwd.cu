// flash_attn_bwd: the gradient of flash_attn_fwd for Hopper (sm_90a).
//
// The JAX package has no backward kernel: its four Pallas kernels
// (videovanish_tpu/ops/attention.py) define no VJP, so its trainer
// differentiates attention only on XLA's route, `_xla_attention` (:30).
// This kernel computes what jax.vjp of `_xla_attention` computes, for the
// shapes flash_attn_fwd takes on the trainer's path (UNet and BrushNet
// self-attention, D = 40/80/160, and the text cross-attention, Sk = 77):
//
//   P  = softmax(scale q k^T)    recomputed from q, k and the forward's
//                                per-row log-sum-exp (log2 domain)
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - rowsum(dO o O)),
//   dQ = scale dS K,  dK = scale dS^T Q
//
// FlashAttention-2's backward in three launches and no atomics, so a rerun
// is bitwise:
//   1. delta = rowsum(dO o O) in f32, one warp a row;
//   2. dK, dV: one CTA per (64-key block, batch*head), four warps of 16
//      keys each; it walks the query blocks, recomputes P^T from K, Q and
//      the log-sum-exp, and accumulates dV and dK in registers;
//   3. dQ: one CTA per (64-query block, batch*head), four warps of 16
//      queries; it walks the key blocks and accumulates dQ.
// Products are mma.sync m16n8k16 (bf16 in, f32 accumulate) with fragments
// from ldmatrix; tiles come in by cp.async into padded shared memory. The
// head dim is padded to 16 (48/80/160) by zero-filled columns; query and
// key tails are zero-filled rows, masked where they would add to a sum
// (P of a padded key is 0; a padded query has an infinite log-sum-exp),
// and padded rows and columns are never written.
//
// What bounds it on an H100: five products of 2 B H Sq Sk D flops each and
// one exponential per score in each of passes 2 and 3; at D = 40 the
// exponentials come close. This first version is simple: one K/V or Q/dO
// buffer (loads and products do not overlap) and mma.sync rather than
// wgmma, so it runs far from that bound (PERF.md, the kernel table).
#include "attn_bwd.cuh"

namespace vv {

constexpr int kBwdWarps = 4;

template <int DK>
struct FlashBwdCfg {
  static constexpr int LD = DK + 8;            // tile pitch, elements
  static constexpr int BN = 16 * kBwdWarps;    // keys of a dK/dV CTA
  static constexpr int BM = DK > 80 ? 32 : 64;  // queries a dK/dV step
  static constexpr int BQ = 16 * kBwdWarps;    // queries of a dQ CTA
  static constexpr int SMEM_KV = (2 * BN + 2 * BM) * LD * 2 + 2 * BM * 4;
  static constexpr int SMEM_Q = (2 * BQ + 2 * BN) * LD * 2;
};

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// delta[b, h, i] = sum_d dO[b, h, i, d] O[b, h, i, d], one warp a row
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const uint16_t* __restrict__ o,
                       const uint16_t* __restrict__ dout,
                       float* __restrict__ delta, int H, int Sq, int D,
                       const BwdStrides st, long long rows) {
  const long long row = blockIdx.x * 8ll + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = static_cast<int>(row % Sq);
  const long long bh = row / Sq;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const uint16_t* po = o + b * st.s[kO][0] + h * st.s[kO][1] + i * st.s[kO][2];
  const uint16_t* pd =
      dout + b * st.s[kDO][0] + h * st.s[kDO][1] + i * st.s[kDO][2];
  float acc = 0.f;
  for (int c = 2 * lane; c < D; c += 64) {
    const uint32_t a = *reinterpret_cast<const uint32_t*>(po + c);
    const uint32_t d = *reinterpret_cast<const uint32_t*>(pd + c);
    acc = fmaf(bf16_lo(a), bf16_lo(d), acc);
    acc = fmaf(bf16_hi(a), bf16_hi(d), acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[row] = acc;
}

template <int DK>
__global__ void __launch_bounds__(32 * kBwdWarps)
flash_bwd_dkdv_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      const uint16_t* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                      int H, int Sq, int Sk, int D, const BwdStrides st,
                      float scale, float scale_log2e) {
  using C = FlashBwdCfg<DK>;
  constexpr int LD = C::LD, BN = C::BN, BM = C::BM;
  constexpr int NT = DK / 8, NQ = BM / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sK = smem_u32(smem), sV = sK + BN * LD * 2,
                 sQ = sV + BN * LD * 2, sdO = sQ + BM * LD * 2;
  float* sL = reinterpret_cast<float*>(smem + (2 * BN + 2 * BM) * LD * 2);
  float* sD = sL + BM;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = lane & 3;
  const uint16_t* qb = q + b * st.s[kQ][0] + h * st.s[kQ][1];
  const uint16_t* kb = k + b * st.s[kK][0] + h * st.s[kK][1];
  const uint16_t* vb = v + b * st.s[kV][0] + h * st.s[kV][1];
  const uint16_t* db = dout + b * st.s[kDO][0] + h * st.s[kDO][1];
  const float* lb = lse + static_cast<long long>(bh) * Sq;
  const float* deb = delta + static_cast<long long>(bh) * Sq;

  load_rows<DK, LD>(sK, kb, st.s[kK][2], k0, BN, Sk, D, tid, 32 * kBwdWarps);
  load_rows<DK, LD>(sV, vb, st.s[kV][2], k0, BN, Sk, D, tid, 32 * kBwdWarps);

  float acc_dk[NT][4], acc_dv[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.f;

  // this warp's 16 keys as A rows; Q and dO as B, by rows (for K Q^T and
  // V dO^T) and transposed (for dS^T Q and P^T dO)
  const uint32_t a_k = a_rows(sK + warp * 16 * LD * 2, LD, lane);
  const uint32_t a_v = a_rows(sV + warp * 16 * LD * 2, LD, lane);
  const uint32_t b_q = b_rows(sQ, LD, lane), b_do = b_rows(sdO, LD, lane);
  const uint32_t bt_q = bt_rows(sQ, LD, lane), bt_do = bt_rows(sdO, LD, lane);

  const int n_qb = (Sq + BM - 1) / BM;
  for (int qi = 0; qi < n_qb; ++qi) {
    const int q0 = qi * BM;
    __syncthreads();  // the previous step's reads of sQ, sdO, sL, sD
    load_rows<DK, LD>(sQ, qb, st.s[kQ][2], q0, BM, Sq, D, tid,
                      32 * kBwdWarps);
    load_rows<DK, LD>(sdO, db, st.s[kDO][2], q0, BM, Sq, D, tid,
                      32 * kBwdWarps);
    for (int i = tid; i < BM; i += 32 * kBwdWarps) {
      const bool ok = q0 + i < Sq;
      sL[i] = ok ? lb[q0 + i] : INFINITY;  // a padded query: P = 0
      sD[i] = ok ? deb[q0 + i] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    // S^T = K Q^T (16 keys x BM queries), then P^T in place
    float s[NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, a_k + ks * 32);
#pragma unroll
      for (int n2 = 0; n2 < NQ / 2; ++n2) {
        uint32_t r[4];
        ldsm_x4(r, b_q + (n2 * 16 * LD + ks * 16) * 2);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(s[2 * n2], a, b0);
        mma_16816(s[2 * n2 + 1], a, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = exp2f(fmaf(s[nt][e], scale_log2e,
                              -sL[nt * 8 + 2 * t + (e & 1)]));

    // dV += P^T dO
#pragma unroll
    for (int j = 0; j < NQ / 2; ++j) {
      uint32_t a[4];
      c_to_a(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t r[4];
        ldsm_x4_trans(r, bt_do + (j * 16 * LD + n2 * 16) * 2);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(acc_dv[2 * n2], a, b0);
        mma_16816(acc_dv[2 * n2 + 1], a, b1);
      }
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) in place
    float dp[NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, a_v + ks * 32);
#pragma unroll
      for (int n2 = 0; n2 < NQ / 2; ++n2) {
        uint32_t r[4];
        ldsm_x4(r, b_do + (n2 * 16 * LD + ks * 16) * 2);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(dp[2 * n2], a, b0);
        mma_16816(dp[2 * n2 + 1], a, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = s[nt][e] * (dp[nt][e] - sD[nt * 8 + 2 * t + (e & 1)]);

    // dK += dS^T Q (scaled at the store)
#pragma unroll
    for (int j = 0; j < NQ / 2; ++j) {
      uint32_t a[4];
      c_to_a(a, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t r[4];
        ldsm_x4_trans(r, bt_q + (j * 16 * LD + n2 * 16) * 2);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(acc_dk[2 * n2], a, b0);
        mma_16816(acc_dk[2 * n2 + 1], a, b1);
      }
    }
  }

  const int row0 = k0 + warp * 16;
  store_rows<NT>(dk + b * st.s[kDK][0] + h * st.s[kDK][1], st.s[kDK][2],
                 acc_dk, scale, row0, Sk, D, lane);
  store_rows<NT>(dv + b * st.s[kDV][0] + h * st.s[kDV][1], st.s[kDV][2],
                 acc_dv, 1.f, row0, Sk, D, lane);
}

template <int DK>
__global__ void __launch_bounds__(32 * kBwdWarps)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q,
                    const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v,
                    const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    uint16_t* __restrict__ dq, int H, int Sq, int Sk, int D,
                    const BwdStrides st, float scale, float scale_log2e) {
  using C = FlashBwdCfg<DK>;
  constexpr int LD = C::LD, BN = C::BN, BQ = C::BQ;
  constexpr int NT = DK / 8, NK = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem), sdO = sQ + BQ * LD * 2,
                 sK = sdO + BQ * LD * 2, sV = sK + BN * LD * 2;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* kb = k + b * st.s[kK][0] + h * st.s[kK][1];
  const uint16_t* vb = v + b * st.s[kV][0] + h * st.s[kV][1];

  load_rows<DK, LD>(sQ, q + b * st.s[kQ][0] + h * st.s[kQ][1], st.s[kQ][2],
                    q0, BQ, Sq, D, tid, 32 * kBwdWarps);
  load_rows<DK, LD>(sdO, dout + b * st.s[kDO][0] + h * st.s[kDO][1],
                    st.s[kDO][2], q0, BQ, Sq, D, tid, 32 * kBwdWarps);

  // this thread's two rows: log-sum-exp and delta (0 for padded queries,
  // whose dQ is never written)
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const long long at = static_cast<long long>(bh) * Sq + row;
    l2[r] = row < Sq ? lse[at] : 0.f;
    dl[r] = row < Sq ? delta[at] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const uint32_t a_q = a_rows(sQ + warp * 16 * LD * 2, LD, lane);
  const uint32_t a_do = a_rows(sdO + warp * 16 * LD * 2, LD, lane);
  const uint32_t b_k = b_rows(sK, LD, lane), b_v = b_rows(sV, LD, lane);
  const uint32_t bt_k = bt_rows(sK, LD, lane);

  const int n_kb = (Sk + BN - 1) / BN;
  for (int ki = 0; ki < n_kb; ++ki) {
    const int k0 = ki * BN;
    __syncthreads();  // the previous step's reads of sK, sV
    load_rows<DK, LD>(sK, kb, st.s[kK][2], k0, BN, Sk, D, tid, 32 * kBwdWarps);
    load_rows<DK, LD>(sV, vb, st.s[kV][2], k0, BN, Sk, D, tid, 32 * kBwdWarps);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T (16 queries x BN keys)
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      uint32_t aq[4], ad[4];
      ldsm_x4(aq, a_q + ks * 32);
      ldsm_x4(ad, a_do + ks * 32);
#pragma unroll
      for (int n2 = 0; n2 < NK / 2; ++n2) {
        uint32_t r[4];
        ldsm_x4(r, b_k + (n2 * 16 * LD + ks * 16) * 2);
        const uint32_t k0f[2] = {r[0], r[1]}, k1f[2] = {r[2], r[3]};
        mma_16816(s[2 * n2], aq, k0f);
        mma_16816(s[2 * n2 + 1], aq, k1f);
        ldsm_x4(r, b_v + (n2 * 16 * LD + ks * 16) * 2);
        const uint32_t v0f[2] = {r[0], r[1]}, v1f[2] = {r[2], r[3]};
        mma_16816(dp[2 * n2], ad, v0f);
        mma_16816(dp[2 * n2 + 1], ad, v1f);
      }
    }
    // dS = P (dP - delta), P = 0 on padded keys
    const int lim = Sk - k0;
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = nt * 8 + 2 * t + (e & 1) < lim
                            ? exp2f(fmaf(s[nt][e], scale_log2e, -l2[r]))
                            : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dl[r]);
      }
    // dQ += dS K (scaled at the store)
#pragma unroll
    for (int j = 0; j < NK / 2; ++j) {
      uint32_t a[4];
      c_to_a(a, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t r[4];
        ldsm_x4_trans(r, bt_k + (j * 16 * LD + n2 * 16) * 2);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(acc[2 * n2], a, b0);
        mma_16816(acc[2 * n2 + 1], a, b1);
      }
    }
  }

  store_rows<NT>(dq + b * st.s[kDQ][0] + h * st.s[kDQ][1], st.s[kDQ][2], acc,
                 scale, q0 + warp * 16, Sq, D, lane);
}

template <int DK>
int launch_flash_bwd(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int B, int H,
                     int Sq, int Sk, int D, const BwdStrides& st,
                     float scale_log2e, cudaStream_t stream) {
  using C = FlashBwdCfg<DK>;
  const float scale = scale_log2e * 0.6931471805599453f;  // ln 2
  auto u16 = [](const void* p) { return static_cast<const uint16_t*>(p); };
  const long long rows = static_cast<long long>(B) * H * Sq;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                           stream>>>(u16(o), u16(dout), delta, H, Sq, D, st,
                                     rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kv = flash_bwd_dkdv_kernel<DK>;
  err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_KV);
  if (err != cudaSuccess) return static_cast<int>(err);
  kv<<<dim3((Sk + C::BN - 1) / C::BN, B * H), 32 * kBwdWarps, C::SMEM_KV,
       stream>>>(u16(q), u16(k), u16(v), u16(dout), lse, delta,
                 static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), H,
                 Sq, Sk, D, st, scale, scale_log2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto qk = flash_bwd_dq_kernel<DK>;
  err = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_Q);
  if (err != cudaSuccess) return static_cast<int>(err);
  qk<<<dim3((Sq + C::BQ - 1) / C::BQ, B * H), 32 * kBwdWarps, C::SMEM_Q,
       stream>>>(u16(q), u16(k), u16(v), u16(dout), lse, delta,
                 static_cast<uint16_t*>(dq), H, Sq, Sk, D, st, scale,
                 scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vv

// Padded head dims the backward is built for: the trainer's SD1.5 heads
// (40, 80, 160); the wrapper refuses others.
extern "C" int vv_flash_bwd_supported(int dp) {
  return dp == 48 || dp == 80 || dp == 160;
}

// q, k, v, o, dO, dq, dk, dv: bf16 (B, H, S, D) views with contiguous D;
// strides holds their (batch, head, row) strides in elements (24 values).
// lse: f32 (B, H, Sq), the forward's log2-domain log-sum-exp; delta: f32
// (B, H, Sq) scratch; scale_log2e: the softmax scale times log2(e), as the
// forward takes it. Launches three kernels on `stream`, allocates nothing,
// returns 0 or a CUDA error.
extern "C" int vv_flash_attn_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, void* dq,
                                 void* dk, void* dv, const float* lse,
                                 float* delta, int B, int H, int Sq, int Sk,
                                 int D, const long long* strides,
                                 float scale_log2e, void* stream) {
  if (B * H > 65535 || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  vv::BwdStrides st;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) st.s[i][j] = strides[3 * i + j];
  const int dp = (D + 15) / 16 * 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 48:  return vv::launch_flash_bwd<48>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D, st, scale_log2e, s);
    case 80:  return vv::launch_flash_bwd<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D, st, scale_log2e, s);
    case 160: return vv::launch_flash_bwd<160>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D, st, scale_log2e, s);
    default:  return static_cast<int>(cudaErrorInvalidValue);
  }
}
