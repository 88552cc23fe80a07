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
// What bounds it on an H100. Five products of 2 B H Sq Sk D flops each and
// one exponential per score: at D = 40 the tensor cores and the
// special-function units come close to each other (the exponentials alone
// are 0.6 of the bound at [D=40,Sq=Sk=1600]); the bytes are far below.
// Reaching that takes wgmma (mma.sync cannot reach the tensor rate) and
// loads that overlap the products.
//
// Design (the FlashAttention-3 backward's shape; two launches, no
// atomics, so a rerun is bitwise):
//   1. dQ and delta: one CTA per (block of 64 NWG queries, batch*head),
//      NWG consumer warpgroups of 64 queries and one producer warpgroup
//      (registers handed over with setmaxnreg). Q and dO stay resident in
//      shared memory; one producer thread streams the key blocks' K and V
//      through a ring of STAGES slots with full/empty mbarriers. Loads are
//      TMA over 4-D maps of the (B, S, H, D) storage: rows past S and
//      columns past D arrive as zeros without a read. Each consumer first
//      takes its rows' delta = rowsum(dO o O) (and writes it for pass 2),
//      then per key block, all on wgmma: S = Q K^T and dP = dO V^T,
//      P = exp2(S scale log2e - lse) (one ex2.approx a score),
//      dS = P (dP - delta), dQ += dS K (dS from registers);
//   2. dK and dV: one CTA per (block of 64 NWG keys, batch*head), K and V
//      resident, the query blocks' Q and dO streamed the same way (their
//      log-sum-exp and delta by the producer warp's plain loads); per
//      query block S^T = K Q^T, dP^T = V dO^T, P^T, dS^T = P^T (dP^T -
//      delta), dV += P^T dO and dK += dS^T Q (P^T, dS^T from registers).
// In both, a warpgroup's turn issues one block's first two products and
// then the previous block's last ones; it computes the block's
// exponentials while those last products and the other warpgroups' turns
// run, and the turn passes from warpgroup to warpgroup (ping-pong).
// Products whose N is the head dim take it rounded to 8 (40 at D = 40);
// only those whose depth is D are padded to 16 (48). Tiles are 64-column
// boxes with the 128-byte swizzle (hopper.cuh). The warpgroup counts, the
// ring depths and the hand-over were chosen by scripts/bwd_ablation.py
// (PERF.md).
//
// Pass 1 recomputes S and dP: 7 products where the bound counts 5, and
// two exponentials a score where it counts one. Folding dQ into pass 2
// instead (each key-block CTA adding its dS K tile into an f32 scratch in
// key-block order, FlashAttention-3's deterministic mode;
// scripts/bwd_variants/) measured slower: its CTA-to-CTA hand-overs (a
// bulk reduction, a fence, a counter) chain the key blocks of every query
// block (PERF.md).
#include <type_traits>

#include "attn_bwd.cuh"

namespace vv {

// DK: head dim padded to 16 (the depth of the products over D); DN: the
// columns of the products whose N is the head dim (D rounded up to 8);
// NWG: consumer warpgroups, each owning 64 resident rows (keys in pass 2,
// queries in pass 1); BS: rows of a streamed tile (queries a pass-2 step,
// keys a pass-1 step); STAGES: ring slots. Warpgroup NWG produces.
template <int DK, int DN, int NWG, int BS, int STAGES>
struct BwdCfg {
  static constexpr int THREADS = 128 * (NWG + 1);
  // registers as flash_attn.cu hands them over: LAUNCH a thread at launch,
  // then PROD for the producer and CONS for the consumers; NWG = 1 keeps
  // what ptxas gives it
  static constexpr int LAUNCH = 65536 / THREADS / 8 * 8;
  static constexpr int PROD = NWG == 2 ? 40 : 24;
  static constexpr int CONS_FIT =
      (THREADS * LAUNCH - 128 * PROD) / (128 * NWG) / 8 * 8;
  static constexpr int CONS = CONS_FIT < 232 ? CONS_FIT : 232;
  static constexpr int CH = (DK + 63) / 64;        // 64-column boxes a row
  static constexpr int BR = 64 * NWG;              // resident rows
  static constexpr int RES_BYTES = CH * BR * 128;  // one resident tile
  static constexpr int STR_BYTES = CH * BS * 128;  // one streamed tile
  // resident pair, ring of streamed pairs (+ pass 2's lse and delta),
  // mbarriers (resident full, STAGES full, STAGES empty)
  static constexpr int SMEM = 1024 + 2 * RES_BYTES +
                              STAGES * (2 * STR_BYTES + 2 * BS * 4) +
                              8 * (1 + 2 * STAGES);
  static_assert(DK % 16 == 0 && DN % 8 == 0 && DN <= DK && BS % 16 == 0,
                "tile shape");
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// accumulator (64 x 8 NJ, f32, wgmma layout) -> bf16 A fragments, k-step
// kk from columns 16 kk .. 16 kk + 15 (the layouts line up, as in
// flash_attn.cu's convert_p)
template <int KS>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[KS][4],
                                         const float (&c)[KS * 8]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_f32(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_f32(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_f32(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_f32(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// Turns to issue products, passed from consumer warpgroup to warpgroup
// with named barriers 1..NWG (flash_attn.cu's ping-pong), so one
// warpgroup's products run while the others compute. Each warpgroup takes
// the same number of turns; the last one hands over once at the start and
// not after its last turn, so every barrier phase completes. With one
// warpgroup it does nothing.
template <int NWG>
struct PingPong {
  int wg;
  __device__ __forceinline__ explicit PingPong(int w) : wg(w) {
    if constexpr (NWG > 1)
      if (wg == NWG - 1) named_bar_arrive(1, 256);
  }
  __device__ __forceinline__ void turn() const {
    if constexpr (NWG > 1) named_bar_sync(1 + wg, 256);
  }
  __device__ __forceinline__ void hand_over(bool last) const {
    if constexpr (NWG > 1)
      if (wg != NWG - 1 || !last) named_bar_arrive(1 + (wg + 1) % NWG, 256);
  }
};

// rows row0 + 16 warp + g (+ 8) of a 64 x DN accumulator times `mul`, as
// bf16 into `out` (row stride rs), rows below `rows` and columns below D
template <int DN>
__device__ __forceinline__ void store_acc(uint16_t* out, long long rs,
                                          const float (&acc)[DN / 2],
                                          float mul, int row0, int rows,
                                          int D, int t) {
  const int warp = t / 32, g = (t % 32) / 4, c4 = t % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= rows) continue;
    uint16_t* p = out + row * rs;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int col = 8 * j + 2 * c4;
      if (col < D)
        *reinterpret_cast<uint32_t*>(p + col) =
            pack_f32(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// Pass 2: dK and dV of one block of BR keys. Maps: tq, tdo boxes of 64
// columns x BS rows; tk, tv 64 x BR.
template <int DK, int DN, int NWG, int BS, int STAGES>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                      int H, int Sq, int Sk, int D, const BwdStrides st,
                      float scale, float scale_log2e) {
  using C = BwdCfg<DK, DN, NWG, BS, STAGES>;
  constexpr int BM = BS;  // queries a step
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + C::RES_BYTES;
  const uint32_t sRing = sV + C::RES_BYTES;  // per slot: Q, dO
  const uint32_t sStat = sRing + STAGES * 2 * C::STR_BYTES;  // lse, delta
  const uint32_t bars = sStat + STAGES * 2 * BM * 4;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto sQ = [&](int s) { return sRing + s * 2 * C::STR_BYTES; };
  auto sdO = [&](int s) { return sQ(s) + C::STR_BYTES; };
  auto sL = [&](int s) { return sStat + s * 2 * BM * 4; };
  auto sDl = [&](int s) { return sL(s) + BM * 4; };

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * C::BR;
  const int n_qb = (Sq + BM - 1) / BM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);   // the producer warp's lanes, one with bytes
      mbar_init(empty(s), NWG);  // one thread a consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: the first warp of the last warpgroup ----
    if constexpr (NWG > 1) reg_dealloc<C::PROD>();
    if (threadIdx.x / 32 != 4 * NWG) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * C::RES_BYTES);
      for (int c = 0; c < C::CH; ++c) {
        tma_load_4d(sK + c * C::BR * 128, &tk, kv_full, 64 * c, k0, h, b);
        tma_load_4d(sV + c * C::BR * 128, &tv, kv_full, 64 * c, k0, h, b);
      }
    }
    const float* lb = lse + static_cast<long long>(bh) * Sq;
    const float* db = delta + static_cast<long long>(bh) * Sq;
    for (int i = 0; i < n_qb; ++i) {
      const int s = i % STAGES;
      mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
      for (int r = lane; r < BM; r += 32) {
        const int row = i * BM + r;
        const bool ok = row < Sq;  // a padded query: P = 0
        st_shared_u32(sL(s) + r * 4, __float_as_uint(ok ? lb[row] : INFINITY));
        st_shared_u32(sDl(s) + r * 4, __float_as_uint(ok ? db[row] : 0.f));
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full(s), 2 * C::STR_BYTES);
        for (int c = 0; c < C::CH; ++c) {
          tma_load_4d(sQ(s) + c * BM * 128, &tq, full(s), 64 * c, i * BM, h,
                      b);
          tma_load_4d(sdO(s) + c * BM * 128, &tdo, full(s), 64 * c, i * BM,
                      h, b);
        }
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 ----
  if constexpr (NWG > 1) reg_alloc<C::CONS>();
  constexpr int RS = BM / 2;   // S^T, dP^T: 64 keys x BM queries
  constexpr int RO = DN / 2;   // dK, dV: 64 keys x DN columns
  constexpr int KS = BM / 16;  // 16-query steps of dV and dK
  const int t = threadIdx.x % 128, c4 = t % 4;
  const uint32_t kw = sK + wg * 64 * 128, vw = sV + wg * 64 * 128;

  float acc_dk[RO], acc_dv[RO], acc_s[RS], acc_dp[RS];
#pragma unroll
  for (int i = 0; i < RO; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  fence_regs(acc_dk);  // zeroed before the first product, not sunk past it
  fence_regs(acc_dv);
  uint32_t pa[KS][4], dsa[KS][4];

  // S^T = K Q^T and dP^T = V dO^T on slot s
  auto mma_sdp = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk / 4) * C::BR * 128 + (kk % 4) * 32;
      const uint32_t offq = (kk / 4) * BM * 128 + (kk % 4) * 32;
      WgmmaSS<BM>::mma(acc_s, desc_sw128(kw + off, 16, 1024),
                       desc_sw128(sQ(s) + offq, 16, 1024), kk > 0);
      WgmmaSS<BM>::mma(acc_dp, desc_sw128(vw + off, 16, 1024),
                       desc_sw128(sdO(s) + offq, 16, 1024), kk > 0);
    }
  };
  // dV += P^T dO and dK += dS^T Q on slot s, P^T and dS^T from registers,
  // dO and Q MN-major (the queries are the depth)
  auto mma_dkdv = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      WgmmaRS<DN>::mma(acc_dv, pa[kk],
                       desc_sw128(sdO(s) + kk * 2048, BM * 128, 1024));
      WgmmaRS<DN>::mma(acc_dk, dsa[kk],
                       desc_sw128(sQ(s) + kk * 2048, BM * 128, 1024));
    }
  };
  PingPong<NWG> pp(wg);
  // one turn: S^T and dP^T of slot s, then dV and dK of slot sp, as two
  // groups (either may be left out)
  auto turn = [&](auto sdp, auto dkdv, int s, int sp, bool last) {
    pp.turn();
    wgmma_fence();
    if constexpr (decltype(sdp)::value) {
      mma_sdp(s);
      wgmma_commit();
    }
    if constexpr (decltype(dkdv)::value) {
      mma_dkdv(sp);
      wgmma_commit();
    }
    pp.hand_over(last);
  };
  // P^T = exp2(S^T scale log2e - lse[query]) and dS^T = P^T (dP^T - delta)
  // of slot s, in f32 in place; column 8j + 2c4 (+1) of the accumulators
  // is query 8j + 2c4 (+1)
  auto softmax = [&](int s) {
    fence_regs(acc_s);
    fence_regs(acc_dp);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float2 l = ld_shared_f32x2(sL(s) + (8 * j + 2 * c4) * 4);
      const float2 d = ld_shared_f32x2(sDl(s) + (8 * j + 2 * c4) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2_approx(
            fmaf(acc_s[4 * j + e], scale_log2e, -((e & 1) ? l.y : l.x)));
        acc_s[4 * j + e] = p;
        acc_dp[4 * j + e] = p * (acc_dp[4 * j + e] - ((e & 1) ? d.y : d.x));
      }
    }
  };

  // Turn i issues S^T and dP^T of query block i, then dV and dK of block
  // i - 1 (the first turn and one more after the last block issue half).
  // The exponentials of block i run while dV and dK of block i - 1 and
  // the other warpgroup's turn run on the tensor cores; P^T and dS^T go to
  // their bf16 fragments once dV and dK have read the old ones. The turns
  // are peeled, so no product is issued on a branch.
  const std::true_type on{};
  const std::false_type off{};
  mbar_wait(kv_full, 0);
  mbar_wait(full(0), 0);
  turn(on, off, 0, 0, false);
  wgmma_wait<0>();
  softmax(0);
  acc_to_a<KS>(pa, acc_s);
  acc_to_a<KS>(dsa, acc_dp);
  for (int i = 1; i < n_qb; ++i) {
    const int s = i % STAGES, sp = (i - 1) % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    turn(on, on, s, sp, false);
    wgmma_wait<1>();  // S^T and dP^T of block i
    softmax(s);
    wgmma_wait<0>();  // dV and dK of block i - 1
    if (t == 0) mbar_arrive(empty(sp));
    acc_to_a<KS>(pa, acc_s);
    acc_to_a<KS>(dsa, acc_dp);
  }
  turn(off, on, 0, (n_qb - 1) % STAGES, true);
  wgmma_wait<0>();
  fence_regs(acc_dv);
  fence_regs(acc_dk);

  const int row0 = k0 + wg * 64;
  store_acc<DN>(dk + b * st.s[kDK][0] + h * st.s[kDK][1], st.s[kDK][2],
                acc_dk, scale, row0, Sk, D, t);
  store_acc<DN>(dv + b * st.s[kDV][0] + h * st.s[kDV][1], st.s[kDV][2],
                acc_dv, 1.f, row0, Sk, D, t);
}

// Pass 1: delta and dQ of one block of BR queries. Maps: tq, tdo boxes of
// 64 columns x BR rows; tk, tv 64 x BS. Writes delta for pass 2.
template <int DK, int DN, int NWG, int BS, int STAGES>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const uint16_t* __restrict__ o,
                    const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    uint16_t* __restrict__ dq, int H, int Sq, int Sk, int D,
                    const BwdStrides st, float scale, float scale_log2e) {
  using C = BwdCfg<DK, DN, NWG, BS, STAGES>;
  constexpr int BN = BS;  // keys a step
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + C::RES_BYTES;
  const uint32_t sRing = sdO + C::RES_BYTES;  // per slot: K, V
  const uint32_t bars = sRing + STAGES * 2 * C::STR_BYTES;
  const uint32_t qd_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto sK = [&](int s) { return sRing + s * 2 * C::STR_BYTES; };
  auto sV = [&](int s) { return sK(s) + C::STR_BYTES; };

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::BR;
  const int n_kb = (Sk + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread ----
    if constexpr (NWG > 1) reg_dealloc<C::PROD>();
    if (threadIdx.x != 128 * NWG) return;
    mbar_arrive_expect_tx(qd_full, 2 * C::RES_BYTES);
    for (int c = 0; c < C::CH; ++c) {
      tma_load_4d(sQ + c * C::BR * 128, &tq, qd_full, 64 * c, q0, h, b);
      tma_load_4d(sdO + c * C::BR * 128, &tdo, qd_full, 64 * c, q0, h, b);
    }
    for (int kt = 0; kt < n_kb; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
      mbar_arrive_expect_tx(full(s), 2 * C::STR_BYTES);
      for (int c = 0; c < C::CH; ++c) {
        tma_load_4d(sK(s) + c * BN * 128, &tk, full(s), 64 * c, kt * BN, h,
                    b);
        tma_load_4d(sV(s) + c * BN * 128, &tv, full(s), 64 * c, kt * BN, h,
                    b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns queries q0 + 64 wg .. + 63 ----
  if constexpr (NWG > 1) reg_alloc<C::CONS>();
  constexpr int RS = BN / 2;   // S, dP: 64 queries x BN keys
  constexpr int RO = DN / 2;   // dQ: 64 queries x DN columns
  constexpr int KS = BN / 16;  // 16-key steps of dQ
  const int t = threadIdx.x % 128;
  const int warp = t / 32, g = (t % 32) / 4, c4 = t % 4;
  const uint32_t qw = sQ + wg * 64 * 128, dow = sdO + wg * 64 * 128;

  // this thread's two query rows: log-sum-exp (infinite on a padded row,
  // so P = 0 there) and delta = rowsum(dO o O), each row's quad taking
  // every fourth column pair; lane c4 = 0 writes delta for pass 2
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + 16 * warp + g + 8 * r;
    const long long at = static_cast<long long>(bh) * Sq + row;
    float acc = 0.f;
    if (row < Sq) {
      const uint16_t* po =
          o + b * st.s[kO][0] + h * st.s[kO][1] + row * st.s[kO][2];
      const uint16_t* pd =
          dout + b * st.s[kDO][0] + h * st.s[kDO][1] + row * st.s[kDO][2];
#pragma unroll
      for (int j = 0; j < DN / 8; ++j) {  // all loads issued at once
        const int c = 8 * j + 2 * c4;
        if (c < D) {
          const uint32_t x = *reinterpret_cast<const uint32_t*>(po + c);
          const uint32_t y = *reinterpret_cast<const uint32_t*>(pd + c);
          acc = fmaf(__uint_as_float(x << 16), __uint_as_float(y << 16), acc);
          acc = fmaf(__uint_as_float(x & 0xffff0000u),
                     __uint_as_float(y & 0xffff0000u), acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[r] = acc;
    l2[r] = row < Sq ? lse[at] : INFINITY;
    if (row < Sq && c4 == 0) delta[at] = acc;
  }

  float acc_dq[RO], acc_s[RS], acc_dp[RS];
#pragma unroll
  for (int i = 0; i < RO; ++i) acc_dq[i] = 0.f;
  fence_regs(acc_dq);  // zeroed before the first product, not sunk past it
  uint32_t dsa[KS][4];
  PingPong<NWG> pp(wg);
  // S = Q K^T and dP = dO V^T on slot s
  auto mma_sdp = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk / 4) * C::BR * 128 + (kk % 4) * 32;
      const uint32_t offk = (kk / 4) * BN * 128 + (kk % 4) * 32;
      WgmmaSS<BN>::mma(acc_s, desc_sw128(qw + off, 16, 1024),
                       desc_sw128(sK(s) + offk, 16, 1024), kk > 0);
      WgmmaSS<BN>::mma(acc_dp, desc_sw128(dow + off, 16, 1024),
                       desc_sw128(sV(s) + offk, 16, 1024), kk > 0);
    }
  };
  // dQ += dS K on slot s, dS from registers, K MN-major (the keys are the
  // depth)
  auto mma_dq = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      WgmmaRS<DN>::mma(acc_dq, dsa[kk],
                       desc_sw128(sK(s) + kk * 2048, BN * 128, 1024));
  };
  // one turn: S and dP of slot s, then dQ of slot sp, as two groups
  // (either may be left out)
  auto turn = [&](auto sdp, auto dq_, int s, int sp, bool last) {
    pp.turn();
    wgmma_fence();
    if constexpr (decltype(sdp)::value) {
      mma_sdp(s);
      wgmma_commit();
    }
    if constexpr (decltype(dq_)::value) {
      mma_dq(sp);
      wgmma_commit();
    }
    pp.hand_over(last);
  };
  // P = exp2(S scale log2e - lse), 0 on the padded keys of a ragged last
  // block (their K rows are zeros, but P there could overflow), and
  // dS = P (dP - delta) of key block kt, in f32 in acc_dp
  auto softmax = [&](int kt) {
    fence_regs(acc_s);
    fence_regs(acc_dp);
    const int lim = kt == n_kb - 1 ? Sk - kt * BN : BN;
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int col = (i / 4) * 8 + 2 * c4 + (i & 1);
      const int r = (i >> 1) & 1;
      const float p = ex2_approx(fmaf(acc_s[i], scale_log2e, -l2[r]));
      acc_dp[i] = col < lim ? p * (acc_dp[i] - dl[r]) : 0.f;
    }
  };

  // Turn kt issues S and dP of key block kt, then dQ of block kt - 1 (the
  // first turn and one more after the last block issue half); the
  // exponentials of block kt run while dQ of block kt - 1 and the other
  // warpgroups' turns run on the tensor cores.
  const std::true_type on{};
  const std::false_type off{};
  mbar_wait(qd_full, 0);
  mbar_wait(full(0), 0);
  turn(on, off, 0, 0, false);
  wgmma_wait<0>();
  softmax(0);
  acc_to_a<KS>(dsa, acc_dp);
  for (int kt = 1; kt < n_kb; ++kt) {
    const int s = kt % STAGES, sp = (kt - 1) % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    turn(on, on, s, sp, false);
    wgmma_wait<1>();  // S and dP of block kt
    softmax(kt);
    wgmma_wait<0>();  // dQ of block kt - 1
    if (t == 0) mbar_arrive(empty(sp));
    acc_to_a<KS>(dsa, acc_dp);
  }
  turn(off, on, 0, (n_kb - 1) % STAGES, true);
  wgmma_wait<0>();
  fence_regs(acc_dq);
  store_acc<DN>(dq + b * st.s[kDQ][0] + h * st.s[kDQ][1], st.s[kDQ][2],
                acc_dq, scale, q0 + wg * 64, Sq, D, t);
}

// static: internal linkage (see small_seq_attn.cu's launch_small)
template <typename Kern>
static int set_smem(Kern kern, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// One instance: pass 1 with NWG1 warpgroups of 64 queries and key steps
// of BN1 through ST1 slots, then pass 2 with NWG2 warpgroups of 64 keys
// and query steps of BM2 through ST2 slots.
template <int DK, int DN, int NWG1, int BN1, int ST1, int NWG2, int BM2,
          int ST2>
static int launch_flash_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, float* delta, void* dq,
                            void* dk, void* dv, int B, int H, int Sq, int Sk,
                            int D, const long long* strides,
                            const BwdStrides& st, float scale_log2e,
                            cudaStream_t stream) {
  using QC = BwdCfg<DK, DN, NWG1, BN1, ST1>;
  using KV = BwdCfg<DK, DN, NWG2, BM2, ST2>;
  const float scale = scale_log2e * 0.6931471805599453f;  // ln 2
  // boxes of 64 columns x a tile's rows of one head, 128-byte swizzle
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint32_t res1[4] = {64, QC::BR, 1, 1}, str1[4] = {64, BN1, 1, 1};
  const cuuint32_t res2[4] = {64, KV::BR, 1, 1}, str2[4] = {64, BM2, 1, 1};
  const long long* sq = strides + 3 * kQ;
  const long long* sk = strides + 3 * kK;
  const long long* sv = strides + 3 * kV;
  const long long* sd = strides + 3 * kDO;
  CUtensorMap tq, tk, tv, tdo;
  int rc = make_map(&tq, q, B, H, Sq, D, sq, res1, sw);
  if (rc == 0) rc = make_map(&tdo, dout, B, H, Sq, D, sd, res1, sw);
  if (rc == 0) rc = make_map(&tk, k, B, H, Sk, D, sk, str1, sw);
  if (rc == 0) rc = make_map(&tv, v, B, H, Sk, D, sv, str1, sw);
  if (rc != 0) return rc;
  auto kern1 = flash_bwd_dq_kernel<DK, DN, NWG1, BN1, ST1>;
  rc = set_smem(kern1, QC::SMEM);
  if (rc != 0) return rc;
  kern1<<<dim3((Sq + QC::BR - 1) / QC::BR, B * H), QC::THREADS, QC::SMEM,
          stream>>>(tq, tk, tv, tdo, static_cast<const uint16_t*>(o),
                    static_cast<const uint16_t*>(dout), lse, delta,
                    static_cast<uint16_t*>(dq), H, Sq, Sk, D, st, scale,
                    scale_log2e);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  rc = make_map(&tq, q, B, H, Sq, D, sq, str2, sw);
  if (rc == 0) rc = make_map(&tdo, dout, B, H, Sq, D, sd, str2, sw);
  if (rc == 0) rc = make_map(&tk, k, B, H, Sk, D, sk, res2, sw);
  if (rc == 0) rc = make_map(&tv, v, B, H, Sk, D, sv, res2, sw);
  if (rc != 0) return rc;
  auto kern2 = flash_bwd_dkdv_kernel<DK, DN, NWG2, BM2, ST2>;
  rc = set_smem(kern2, KV::SMEM);
  if (rc != 0) return rc;
  kern2<<<dim3((Sk + KV::BR - 1) / KV::BR, B * H), KV::THREADS, KV::SMEM,
          stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<uint16_t*>(dk),
                    static_cast<uint16_t*>(dv), H, Sq, Sk, D, st, scale,
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
// forward takes it. Launches two kernels on `stream`, allocates nothing,
// returns 0, a CUDA error, or 1000 + the CUresult of a refused tensor map.
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
  // D <= 80: three warpgroups in pass 1 (scripts/bwd_ablation.py); D = 160:
  // pass 2 with one warpgroup of keys and 32-query steps, whose dK and dV
  // accumulators (64 x 160 f32 each) leave little room
  switch (dp) {
    case 48:
      return D == 40
          ? vv::launch_flash_bwd<48, 40, 3, 64, 3, 2, 64, 3>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D, strides, st, scale_log2e, s)
          : vv::launch_flash_bwd<48, 48, 3, 64, 3, 2, 64, 3>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D, strides, st, scale_log2e, s);
    case 80:  return vv::launch_flash_bwd<80, 80, 3, 64, 3, 2, 64, 3>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D, strides, st, scale_log2e, s);
    case 160: return vv::launch_flash_bwd<160, 160, 2, 64, 2, 1, 32, 3>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D, strides, st, scale_log2e, s);
    default:  return static_cast<int>(cudaErrorInvalidValue);
  }
}
