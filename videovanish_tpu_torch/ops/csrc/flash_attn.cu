// flash_attn_fwd: online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the two flash kernels of videovanish_tpu/ops/attention.py:
//   _flash_kernel_inline (:50)  head dims that are not a multiple of 128
//                               (SD1.5 spatial attention, D = 40/80/160;
//                               Hiera's windowed and global attention,
//                               D = 72; the SAM2 mask decoder's
//                               token-to-image attention, D = 16)
//   _flash_kernel_iota   (:120) lane-aligned head dims (the VAE mid-block's
//                               single 512-wide head; SAM2 memory
//                               self-attention, one 256-wide head)
// and, beyond the JAX package, Wan2.1's DiT (self-attention over f*h*w
// tokens and cross-attention to 512 text rows, D = 128) and the Wan-VAE's
// mid-block (one 384-wide head over a frame's pixels).
// Both compute softmax(q k^T * scale) v with an f32 running max and sum;
// one template covers both.
//
// What bounds it on an H100. Per score it does 2*D tensor-core flops for
// q k^T, 2*D for p v, and one exponential. The special-function units give
// 16 ex2 per SM per clock against 4096 bf16 flops, so at D = 40 (48 in the
// products) the exponentials are the bound, with the tensor cores close
// behind; at D = 80 and up the tensor cores are. q/k/v/o bytes are small.
// In practice the D = 40 instance is held back by latency: dropping the
// softmax or the p v products entirely saves only a few per cent
// (scripts/flash_ablation.py), and what helped was more warpgroups in
// flight. A 64-row query tile at D = 512 re-reads 2 KB of K and V per key
// from L2 and its products read Q and K from shared memory, so shared
// memory and L2 bandwidth come close to bounding that instance.
//
// Design:
//   * one CTA per (batch*head, query tile) with NWG consumer warpgroups and
//     one producer warpgroup (warp specialisation). The producer gives its
//     registers to the consumers (setmaxnreg) and one of its threads issues
//     every load;
//   * loads are TMA (cp.async.bulk.tensor, 4-D tensor maps over the
//     (B, S, H, D) storage behind the (B, H, S, D) views, 64-column boxes,
//     128-byte swizzle), completing on mbarriers. TMA rather than cp.async:
//     it zero-fills whatever lies outside the tensor, so padding D up to the
//     box (40 -> 64), the ragged Sq and Sk tails and the last head cost no
//     instructions and read nothing out of bounds; and one thread issues a
//     whole tile. Q is loaded once; K and V go through a ring of STAGES
//     slots with separate full/empty barriers, so K of the next tile loads
//     while the consumers still run p v on the current V;
//   * both products are wgmma: S = Q K^T with Q and K K-major in shared
//     memory (depth DK, the head dim padded to 16), O += P V with P taken
//     from registers (the S accumulator converted in place to bf16, whose
//     layout is the A-fragment layout) and V MN-major (transpose bit), at
//     N = DK output columns (48/80/160), not the 64-column box;
//   * softmax: the row max is taken on the raw scores, and every
//     exponential is one FFMA (s * scale*log2e - m * scale*log2e, so the
//     scale costs nothing per score) feeding ex2.approx.ftz. Only the last
//     key tile, and only when Sk is ragged, is masked;
//   * D <= 160 (SPLIT = 1): each consumer warpgroup owns 64 query rows and
//     all output columns (3 warpgroups, 192 rows, at D = 40; 2 at D = 72,
//     80, 128 and 160, whose accumulators need the registers; 128-key
//     tiles up to D = 128, 64 at D = 160). Each warpgroup
//     issues S of tile kt together with P V of tile kt-1 and computes the
//     exponentials of tile kt while that P V runs; named barriers pass the
//     turn to issue products from warpgroup to warpgroup (ping-pong);
//   * D = 16: one consumer warpgroup (the decoder's 22 queries fill less
//     than one 64-row tile), no ping-pong and no register hand-over, and a
//     4-slot K/V ring, since one warpgroup has nothing to overlap its loads
//     with but the loads themselves. The 16 columns sit in a zero-filled
//     64-column box (TMA reads 32 bytes a row);
//   * D = 256, 384 and 512 (SPLIT = 2): a 64 x D f32 output needs more than one
//     warpgroup's registers next to S and P (D = 256: 128 a thread), so two
//     warpgroups share 64 query rows and own D / 2 output columns each.
//     Warpgroup 0 computes the scores and softmax
//     and hands P (bf16) and the row factors to warpgroup 1 through a
//     double-buffered shared-memory slot. Both warpgroups computing the
//     scores instead (1.5x the products) measured slower;
//   * a row whose softmax sum is 0 is divided by 1, as the TPU kernels do;
//     the output goes to (B, S, H, D) storage through its strides.
#include <cuda.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace vv {

// DK: head dim padded to 16 (the q k^T depth); BN: keys per tile; STAGES:
// K/V ring depth; SPLIT: warpgroups sharing one 64-row query block (1, or 2
// at D >= 256, where warpgroup 0 computes the scores and hands P to
// warpgroup 1 through shared memory); NWG: consumer warpgroups (warpgroup
// NWG is the producer)
template <int DK, int BN, int STAGES, int SPLIT, int NWG>
struct FlashCfg {
  static constexpr int THREADS = 128 * (NWG + 1);
  // registers per thread: LAUNCH (a multiple of 8) at launch, then the
  // producer drops to PROD and the consumers rise to CONS; setmaxnreg only
  // moves registers the CTA already holds, so NWG*128*CONS + 128*PROD must
  // stay within THREADS*LAUNCH or the consumers wait forever. NWG = 1
  // skips the hand-over and keeps the registers ptxas gives it
  static constexpr int LAUNCH = 65536 / THREADS / 8 * 8;
  static constexpr int PROD = NWG == 2 ? 40 : 24;
  static constexpr int CONS_FIT =
      (THREADS * LAUNCH - 128 * PROD) / (128 * NWG) / 8 * 8;
  static constexpr int CONS = CONS_FIT < 232 ? CONS_FIT : 232;
  static constexpr int DP = (DK + 63) / 64 * 64;  // columns kept per row
  static constexpr int CH = DP / 64;              // 64-column boxes per row
  static constexpr int BM = 64 * NWG / SPLIT;     // query rows per CTA
  static constexpr int NO = DK / SPLIT;  // output columns per warpgroup
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;
  // SPLIT = 2: two P buffers (64 x BN bf16), their row factors, row sums
  static constexpr int P_BYTES = SPLIT == 2 ? 2 * 64 * BN * 2 + 3 * 64 * 4 : 0;
  static constexpr int N_BARS = 1 + 4 * STAGES + (SPLIT == 2 ? 4 : 0);
  static constexpr int K_READERS = SPLIT == 2 ? 1 : NWG;  // warpgroups on K
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + P_BYTES + 8 * N_BARS;
  static_assert(DK % 16 == 0 && BN % 16 == 0 && (SPLIT == 1 || NO % 64 == 0),
                "tile shape");
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(SPLIT == 1 || NWG == 2, "P is shared by two warpgroups");
};

template <int DK, int BN, int STAGES, int SPLIT, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 uint16_t* __restrict__ o, float* __restrict__ lse, int H,
                 int Sq, int Sk, int D, long long osb, long long osh,
                 long long oss, float scale_log2e) {
  using C = FlashCfg<DK, BN, STAGES, SPLIT, NWG>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;            // STAGES x KV_BYTES
  const uint32_t sV = sK + STAGES * C::KV_BYTES;  // STAGES x KV_BYTES
  const uint32_t sP = sV + STAGES * C::KV_BYTES;  // SPLIT = 2: 2 P buffers,
  const uint32_t sAlpha = sP + 2 * 64 * BN * 2;   // 2 x 64 row factors,
  const uint32_t sL = sAlpha + 2 * 64 * 4;        // 64 row sums
  const uint32_t bars = sP + C::P_BYTES;
  const uint32_t q_full = bars;
  // per stage: K full, V full, K empty, V empty
  auto bar = [&](int s, int which) { return bars + 8 * (1 + 4 * s + which); };
  // SPLIT = 2, per P buffer: full (128 arrivals), empty (1)
  auto pbar = [&](int i, int which) {
    return bars + 8 * (1 + 4 * STAGES + 2 * i + which);
  };

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * C::BM;
  const int n_kt = (Sk + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(s, 0), 1);
      mbar_init(bar(s, 1), 1);
      // one thread of each consumer warpgroup releases a slot once the
      // warpgroup's products that read it have completed
      mbar_init(bar(s, 2), C::K_READERS);
      mbar_init(bar(s, 3), NWG);
    }
    if constexpr (SPLIT == 2) {
      for (int i = 0; i < 2; ++i) {
        mbar_init(pbar(i, 0), 128);
        mbar_init(pbar(i, 1), 1);
      }
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer ----
    if constexpr (NWG > 1) reg_dealloc<C::PROD>();
    if (threadIdx.x == 128 * NWG) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::CH; ++c)
        tma_load_4d(sQ + c * C::BM * 128, &tq, q_full, 64 * c, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        const uint32_t ph = (kt / STAGES) & 1;
        mbar_wait(bar(s, 2), ph ^ 1);
        mbar_arrive_expect_tx(bar(s, 0), C::KV_BYTES);
        for (int c = 0; c < C::CH; ++c)
          tma_load_4d(sK + s * C::KV_BYTES + c * BN * 128, &tk, bar(s, 0),
                      64 * c, kt * BN, h, b);
        mbar_wait(bar(s, 3), ph ^ 1);
        mbar_arrive_expect_tx(bar(s, 1), C::KV_BYTES);
        for (int c = 0; c < C::CH; ++c)
          tma_load_4d(sV + s * C::KV_BYTES + c * BN * 128, &tv, bar(s, 1),
                      64 * c, kt * BN, h, b);
      }
    }
  } else {
    // ---- consumers ----
    if constexpr (NWG > 1) reg_alloc<C::CONS>();
    constexpr int RS = BN / 2;     // score accumulator registers
    constexpr int RO = C::NO / 2;  // output accumulator registers
    const int t = threadIdx.x % 128;
    const int warp = t / 32, g = (t % 32) / 4, c4 = t % 4;
    const int row0 = SPLIT == 1 ? 64 * wg : 0;     // rows of the CTA tile
    const int col0 = SPLIT == 1 ? 0 : C::NO * wg;  // output columns

    float acc_o[RO];
#pragma unroll
    for (int i = 0; i < RO; ++i) acc_o[i] = 0.f;
    float acc_s[RS];  // the first k-step of each S = Q K^T overwrites it
    uint32_t pa[BN / 16][4];  // P of the previous tile, bf16 A fragments
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    float alpha[2];

    // issue S = Q K^T on the K tile of stage s (not waited for)
    auto issue_qk = [&](int s) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
        const uint64_t da = desc_sw128(
            sQ + (kk / 4) * C::BM * 128 + row0 * 128 + off, 16, 1024);
        const uint64_t db = desc_sw128(
            sK + s * C::KV_BYTES + (kk / 4) * BN * 128 + off, 16, 1024);
        WgmmaSS<BN>::mma(acc_s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // issue O += P V on the V tile of stage s (not waited for)
    auto issue_pv = [&](int s) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = desc_sw128(
            sV + s * C::KV_BYTES + (col0 / 64) * BN * 128 + kk * 2048,
            BN * 128, 1024);
        WgmmaRS<C::NO>::mma(acc_o, pa[kk], db);
      }
      wgmma_commit();
    };
    // online softmax of tile kt in the log2 domain: acc_s becomes P,
    // alpha the factor for the output so far
    auto softmax = [&](int kt) {
      if (kt == n_kt - 1 && Sk % BN != 0) {  // ragged key tail, last tile
        const int lim = Sk - kt * BN;
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          const int col = (i / 4) * 8 + 2 * c4 + (i & 1);
          if (col >= lim) acc_s[i] = -INFINITY;
        }
      }
      // row max and sum in 8 partials per row, not one long chain
      float part[2][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) part[0][j] = m_run[0], part[1][j] = m_run[1];
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        float& m = part[(i >> 1) & 1][(i & 1) | ((i >> 1) & 6)];
        m = fmaxf(m, acc_s[i]);
      }
      float mx[2], neg_m[2], lsum[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(fmaxf(fmaxf(part[r][0], part[r][1]),
                            fmaxf(part[r][2], part[r][3])),
                      fmaxf(fmaxf(part[r][4], part[r][5]),
                            fmaxf(part[r][6], part[r][7])));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // the first key tile always holds a valid key, so mx is finite
        alpha[r] = ex2_approx((m_run[r] - mx[r]) * scale_log2e);
        neg_m[r] = -mx[r] * scale_log2e;
        m_run[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) part[0][j] = part[1][j] = 0.f;
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const int r = (i >> 1) & 1;
        const float p = ex2_approx(fmaf(acc_s[i], scale_log2e, neg_m[r]));
        acc_s[i] = p;
        part[r][(i & 1) | ((i >> 1) & 6)] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lsum[r] = ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3])) +
                  ((part[r][4] + part[r][5]) + (part[r][6] + part[r][7]));
        l_run[r] = l_run[r] * alpha[r] + lsum[r];
      }
    };
    // P to bf16 A fragments: score n-blocks 2kk and 2kk+1 form k-step kk
    auto convert_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_f32(acc_s[8 * kk + 0], acc_s[8 * kk + 1]);
        pa[kk][1] = pack_f32(acc_s[8 * kk + 2], acc_s[8 * kk + 3]);
        pa[kk][2] = pack_f32(acc_s[8 * kk + 4], acc_s[8 * kk + 5]);
        pa[kk][3] = pack_f32(acc_s[8 * kk + 6], acc_s[8 * kk + 7]);
      }
    };

    auto release = [&](uint32_t b) {
      if (t == 0) mbar_arrive(b);
    };
    mbar_wait(q_full, 0);
    if constexpr (SPLIT == 1) {
      // Pipelined within the warpgroup: S of tile kt is computed while P V
      // of tile kt-1 runs, and the exponentials of tile kt overlap that
      // P V. Across the two warpgroups, named barriers 1 and 2 hand the
      // turn to issue products back and forth (ping-pong), so one
      // warpgroup's products run while the other computes exponentials.
      // Each warpgroup takes n_kt turns; warpgroup 1 hands over once at
      // the start and not after its last turn, so every barrier phase
      // completes. A single warpgroup takes every turn itself.
      auto turn = [&]() {
        if constexpr (NWG > 1) named_bar_sync(1 + wg, 256);
      };
      auto hand_over = [&](bool last) {
        if constexpr (NWG > 1)
          if (wg != NWG - 1 || !last)
            named_bar_arrive(1 + (wg + 1) % NWG, 256);
      };
      if constexpr (NWG > 1)
        if (wg == NWG - 1) named_bar_arrive(1, 256);
      mbar_wait(bar(0, 0), 0);
      turn();
      issue_qk(0);
      hand_over(n_kt == 1);
      wgmma_wait<0>();
      fence_regs(acc_s);
      release(bar(0, 2));
      softmax(0);
      convert_p();
      for (int kt = 1; kt < n_kt; ++kt) {
        const int s = kt % STAGES, sp = (kt - 1) % STAGES;
        mbar_wait(bar(s, 0), (kt / STAGES) & 1);
        mbar_wait(bar(sp, 1), ((kt - 1) / STAGES) & 1);
        turn();
        issue_qk(s);
        issue_pv(sp);
        hand_over(kt == n_kt - 1);
        wgmma_wait<1>();  // S of tile kt is ready; P V of kt-1 may still run
        fence_regs(acc_s);
        release(bar(s, 2));
        softmax(kt);
        wgmma_wait<0>();
        fence_regs(acc_o);
        release(bar(sp, 3));
#pragma unroll
        for (int i = 0; i < RO; ++i) acc_o[i] *= alpha[(i >> 1) & 1];
        convert_p();
      }
      const int sl = (n_kt - 1) % STAGES;
      mbar_wait(bar(sl, 1), ((n_kt - 1) / STAGES) & 1);
      issue_pv(sl);
      wgmma_wait<0>();
      fence_regs(acc_o);
      release(bar(sl, 3));
    } else {
      // D = 512 with P shared: warpgroup 0 computes S, the softmax and P,
      // stores P (bf16, in the 128-byte-swizzled K-major layout wgmma reads)
      // and the row factors into one of two buffers, and runs P V for its
      // 256 columns from registers; warpgroup 1 rescales its 256 columns by
      // the stored factors and runs P V with P from shared memory
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES, pb = kt & 1;
        const uint32_t ph = (kt / STAGES) & 1, pph = (kt >> 1) & 1;
        const uint32_t sPb = sP + pb * 64 * BN * 2;
        if (wg == 0) {
          mbar_wait(bar(s, 0), ph);
          issue_qk(s);
          wgmma_wait<0>();
          fence_regs(acc_s);
          release(bar(s, 2));
          softmax(kt);
          mbar_wait(pbar(pb, 1), pph ^ 1);
#pragma unroll
          for (int i = 0; i < RS; i += 2) {
            const int row = 16 * warp + g + 8 * ((i >> 1) & 1);
            const int col = (i / 4) * 8 + 2 * c4;
            st_shared_u32(sPb + row * 128 +
                              ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) * 2)),
                          pack_f32(acc_s[i], acc_s[i + 1]));
          }
          if (c4 == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
              st_shared_u32(sAlpha + (pb * 64 + 16 * warp + g + 8 * r) * 4,
                            __float_as_uint(alpha[r]));
          }
          fence_proxy_async();
          mbar_arrive(pbar(pb, 0));
          convert_p();
        } else {
          mbar_wait(pbar(pb, 0), pph);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            alpha[r] =
                ld_shared_f32(sAlpha + (pb * 64 + 16 * warp + g + 8 * r) * 4);
        }
#pragma unroll
        for (int i = 0; i < RO; ++i) acc_o[i] *= alpha[(i >> 1) & 1];
        mbar_wait(bar(s, 1), ph);
        if (wg == 0) {
          issue_pv(s);
        } else {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            const uint64_t da = desc_sw128(sPb + kk * 32, 16, 1024);
            const uint64_t db = desc_sw128(
                sV + s * C::KV_BYTES + (col0 / 64) * BN * 128 + kk * 2048,
                BN * 128, 1024);
            WgmmaSS<C::NO, true>::mma(acc_o, da, db, 1);
          }
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(acc_o);
        release(bar(s, 3));
        if (wg == 1) release(pbar(pb, 1));
      }
    }

    // finish: full row sums across the quad, l == 0 -> 1, store valid rows
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = l;
    }
    if constexpr (SPLIT == 2) {  // warpgroup 0 holds the sums of both
      const uint32_t at = sL + (16 * warp + g) * 4;
      if (wg == 0 && c4 == 0) {
        st_shared_u32(at, __float_as_uint(inv[0]));
        st_shared_u32(at + 32, __float_as_uint(inv[1]));
      }
      named_bar_sync(1, 256);
      if (wg == 1) inv[0] = ld_shared_f32(at), inv[1] = ld_shared_f32(at + 32);
    }
    if constexpr (SPLIT == 1) {
      // the backward's row statistics: log2 of the softmax denominator in
      // the scaled log2 domain, so that P = exp2(s * scale_log2e - lse)
      if (lse != nullptr && c4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + row0 + 16 * warp + g + 8 * r;
          if (row < Sq)
            lse[(static_cast<long long>(b) * H + h) * Sq + row] =
                fmaf(m_run[r], scale_log2e, log2f(inv[r]));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / (inv[r] == 0.f ? 1.f : inv[r]);
    uint16_t* ob = o + b * osb + h * osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 16 * warp + g + 8 * r;
      if (row >= Sq) continue;
      uint16_t* orow = ob + row * oss;
#pragma unroll
      for (int j = 0; j < C::NO / 8; ++j) {
        const int col = col0 + 8 * j + 2 * c4;
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_f32(acc_o[4 * j + 2 * r] * inv[r],
                       acc_o[4 * j + 2 * r + 1] * inv[r]);
      }
    }
  }
}

template <int DK, int BN, int STAGES, int SPLIT, int NWG>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int Sq, int Sk, int D,
                 const long long* st, float scale_log2e, cudaStream_t stream) {
  using C = FlashCfg<DK, BN, STAGES, SPLIT, NWG>;
  // boxes of 64 columns x a tile's rows of one head, 128-byte swizzle
  const cuuint32_t qbox[4] = {64, C::BM, 1, 1}, kvbox[4] = {64, BN, 1, 1};
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, B, H, Sq, D, st, qbox, sw);
  if (rc == 0) rc = make_map(&tk, k, B, H, Sk, D, st + 3, kvbox, sw);
  if (rc == 0) rc = make_map(&tv, v, B, H, Sk, D, st + 6, kvbox, sw);
  if (rc != 0) return rc;
  auto kern = flash_fwd_kernel<DK, BN, STAGES, SPLIT, NWG>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + C::BM - 1) / C::BM, B * H);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<uint16_t*>(o), lse, H, Sq, Sk, D, st[9], st[10],
      st[11], scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vv

// Padded head dims this library is built for: those the port dispatches
// (SD1.5 heads of 40/80/160, the VAE's 512; SAM2's 16, 72 and 256; Wan's
// DiT heads of 128 and its VAE's single 384-wide head); the wrapper
// refuses others.
extern "C" int vv_flash_supported(int dp) {
  switch (dp) {
    case 16: case 48: case 80: case 128: case 160: case 256: case 384:
    case 512:
      return 1;
    default:
      return 0;
  }
}

// q/k/v/o: bf16 (B, H, S, D) views with contiguous D; strides holds the
// (batch, head, row) strides of q, k, v, o in elements (12 values). lse:
// null, or f32 (B, H, Sq) that receives each row's log-sum-exp in the
// scaled log2 domain for flash_attn_bwd (head dims up to 160). Launches on
// `stream`, allocates nothing, returns 0, a CUDA error, or 1000 + the
// CUresult of a refused tensor map.
extern "C" int vv_flash_attn_fwd(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int H, int Sq,
                                 int Sk, int D, const long long* strides,
                                 float scale_log2e, void* stream) {
  const int dp = (D + 15) / 16 * 16;
  if (lse != nullptr && dp > 160)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 16:  return vv::launch_flash<16, 128, 4, 1, 1>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 48:  return vv::launch_flash<48, 128, 2, 1, 3>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 80:  return vv::launch_flash<80, 128, 2, 1, 2>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 128: return vv::launch_flash<128, 128, 2, 1, 2>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 160: return vv::launch_flash<160, 64, 2, 1, 2>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 256: return vv::launch_flash<256, 64, 2, 2, 2>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 384: return vv::launch_flash<384, 64, 1, 2, 2>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, scale_log2e, s);
    case 512: return vv::launch_flash<512, 64, 1, 2, 2>(q, k, v, o, lse, B, H, Sq, Sk, D, strides, scale_log2e, s);
    default:  return static_cast<int>(cudaErrorInvalidValue);
  }
}
