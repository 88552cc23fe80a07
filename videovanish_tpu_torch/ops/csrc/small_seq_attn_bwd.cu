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
// What bounds it on an H100: bytes, as the forward. A (sequence, head)
// pair reads q, k, v, o, dO and writes dq, dk, dv (8 S D bf16 values) for
// 10 S^2 D flops, 14 flops a byte at S = 22: the design is about keeping
// bytes in flight while the warps compute.
//
// Design (small_seq_attn.cu's, for the backward):
//   * units and persistent CTAs: a unit is one sequence times PAIRS
//     consecutive heads. One CTA per SM walks units u = blockIdx.x +
//     i * gridDim.x, head groups fastest, so neighbouring CTAs read the
//     heads of one token row at the same time and share its 32-byte
//     sectors in L2;
//   * a ring of slots: one producer thread loads each unit's q, k, v, o and
//     dO with five TMA loads (4-D maps of the storage; boxes of LD columns
//     x S padded to 16 rows x PAIRS heads) into a ring of up to 4 slots
//     with full and empty mbarriers, and runs ahead by as many units. TMA
//     zero-fills rows past S, columns past D and heads past H without
//     reading them. Consumer warps never issue a global load;
//   * consumer warps: WPP = 2 warps a pair (1 where S <= 16), 8 warps a CTA
//     at most. Per unit, each warp of a pair takes every other 16-query
//     strip and computes delta = rowsum(dO o O) from the slot, S = q k^T,
//     the exact f32 softmax P (the forward's arithmetic), dP = dO v^T and
//     dS = P (dP - delta), and stores P and dS (bf16) into the pair's
//     scratch beside the ring; after a barrier of the pair it takes every
//     other query strip of dq = scale dS k and every other key strip of
//     dv = P^T dO and dk = scale dS^T q (P^T and dS^T read with
//     ldmatrix.trans), each written straight to its rows;
//   * PAIRS is the most heads (a power of two, no more than H needs) of
//     which two slots fit beside their scratch; the ring takes as many
//     slots as fit. At S = 22: 4 heads and 3 slots at D = 40, 4 and 2 at
//     D = 80, 2 and 2 at D = 160. Where not even two slots of one head fit
//     (S = 64 at D = 160) the ring has one and loads do not overlap;
//   * products stay on mma.sync m16n8k16 (bf16 in, f32 accumulate) with
//     fragments from ldmatrix: a pair's products are 22 x 32 x D, far under
//     wgmma's 64-row tile, and the tensor work is not what bounds it.
// No atomics: a rerun is bitwise.
#include <cuda.h>

#include "attn_bwd.cuh"

namespace vv {

constexpr int kSbMaxS = 64;
constexpr int kSbWarps = 8;       // consumer warps of a CTA, at most
constexpr int kSbMaxPairs = 8;    // heads of a unit, at most
constexpr int kSbMaxStages = 4;   // ring slots, at most
constexpr long long kSbCeiling = 232448;  // a block's shared memory on sm_90
constexpr int kSbReserve = 256;   // alignment slack and the mbarriers
constexpr int kSbMaxDevices = 64;

__host__ __device__ constexpr int sb_pad16(int s) { return (s + 15) / 16 * 16; }

// row pitch of the q, k, v, o, dO tiles, elements: small_seq_attn.cu's
// small_pitch (16 bytes more where DP * 2 is a multiple of 64, so the 8
// rows of one ldmatrix phase do not fall in 2 of the 8 bank groups)
__host__ __device__ constexpr int sb_pitch(int dp) {
  return dp % 32 == 0 ? dp + 8 : dp;
}

// one pair's tiles in a slot: q, o, dO (Sq rows) and k, v (Sk rows),
// padded to 16 rows, at pitch sb_pitch
inline long long sb_pair_bytes(int dp, int sq, int sk) {
  return (3LL * sb_pad16(sq) + 2LL * sb_pad16(sk)) * sb_pitch(dp) * 2;
}

// one pair's scratch beside the ring: P and dS (bf16, Sq x Sk padded to 16
// at pitch Sk + 8) and delta (f32), 128-byte aligned
__host__ __device__ constexpr int sb_scratch_bytes(int sq, int sk) {
  return (2 * sb_pad16(sq) * (sb_pad16(sk) + 8) * 2 + sb_pad16(sq) * 4 +
          127) / 128 * 128;
}

struct SmallBwdPlan {
  int pairs;   // heads per unit
  int wpp;     // consumer warps per pair
  int stages;  // ring slots (0: the shape does not fit)
  long long slot_bytes;
};

inline SmallBwdPlan small_bwd_plan(int dp, int H, int sq, int sk) {
  const long long pair = sb_pair_bytes(dp, sq, sk);
  const long long scr = sb_scratch_bytes(sq, sk);
  const long long budget = kSbCeiling - kSbReserve;
  const int wpp = sb_pad16(sq) > 16 ? 2 : 1;
  auto slots = [&](int p) { return (budget - p * scr) / (p * pair); };
  int pairs = kSbMaxPairs;
  while (pairs > 1 && (pairs * wpp > kSbWarps || pairs / 2 >= H ||
                       slots(pairs) < 2))
    pairs /= 2;
  long long stages = slots(pairs);
  if (stages > kSbMaxStages) stages = kSbMaxStages;
  if (stages < 0) stages = 0;
  return {pairs, wpp, static_cast<int>(stages), pairs * pair};
}

template <int DP>
__global__ void __launch_bounds__(32 * (kSbWarps + 1), 1)
small_seq_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to,
                     const __grid_constant__ CUtensorMap tdo,
                     uint16_t* __restrict__ dq, uint16_t* __restrict__ dk,
                     uint16_t* __restrict__ dv, int B, int H, int Sq, int Sk,
                     int D, const BwdStrides st, int pairs, int wpp,
                     int stages, float scale, float scale_log2e) {
  constexpr int LD = sb_pitch(DP);
  constexpr int NT = DP / 8;
  const int sqp = sb_pad16(Sq), skp = sb_pad16(Sk);
  const int LP = skp + 8;  // pitch of the P and dS tiles
  const uint32_t q_bytes = pairs * sqp * LD * 2;
  const uint32_t kv_bytes = pairs * skp * LD * 2;
  const uint32_t slot = 3 * q_bytes + 2 * kv_bytes;  // q, k, v, o, dO
  const uint32_t scr = sb_scratch_bytes(Sq, Sk);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  const uint32_t scratch = base + stages * slot;
  const uint32_t bars = scratch + pairs * scr;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kSbMaxStages + s); };

  const int n_cons = pairs * wpp;  // consumer warps; warp n_cons produces
  const int head_groups = (H + pairs - 1) / pairs;
  const int n_units = B * head_groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), n_cons);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == n_cons) {
    // ---- producer: one thread keeps up to `stages` units loading ----
    if (lane == 0) {
      int i = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++i) {
        const int s = i % stages;
        mbar_wait(empty(s), ((i / stages) & 1) ^ 1);
        const int b = u / head_groups, h0 = (u % head_groups) * pairs;
        const uint32_t dst = base + s * slot;
        mbar_arrive_expect_tx(full(s), slot);
        tma_load_4d(dst, &tq, full(s), 0, 0, h0, b);
        tma_load_4d(dst + q_bytes, &tk, full(s), 0, 0, h0, b);
        tma_load_4d(dst + q_bytes + kv_bytes, &tv, full(s), 0, 0, h0, b);
        tma_load_4d(dst + q_bytes + 2 * kv_bytes, &to, full(s), 0, 0, h0, b);
        tma_load_4d(dst + 2 * q_bytes + 2 * kv_bytes, &tdo, full(s), 0, 0, h0,
                    b);
      }
    }
    return;
  }

  // ---- consumers: warp `warp` takes pair warp / wpp of every unit, and
  // strips warp % wpp, + wpp, ... of it ----
  const int p = warp / wpp, w0 = warp % wpp;
  const int g = lane >> 2, t = lane & 3;
  const int ks_n = skp / 16, qs_n = sqp / 16;
  const uint32_t sP = scratch + p * scr, sdS = sP + sqp * LP * 2,
                 sDelta = sdS + sqp * LP * 2;
  // the pair's two warps meet (named barrier 1 + p); one warp alone syncs
  auto pair_sync = [&]() {
    if (wpp > 1)
      named_bar_sync(1 + p, 32 * wpp);
    else
      __syncwarp();
  };
  int i = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++i) {
    const int s = i % stages;
    mbar_wait(full(s), (i / stages) & 1);
    __syncwarp();  // converged before the .aligned ldmatrix / mma.sync
    const int b = u / head_groups, h = (u % head_groups) * pairs + p;
    if (h < H) {
      const uint32_t slot0 = base + s * slot;
      const uint32_t sQ = slot0 + p * sqp * LD * 2;
      const uint32_t sK = slot0 + q_bytes + p * skp * LD * 2;
      const uint32_t sV = sK + kv_bytes;
      const uint32_t sO = slot0 + q_bytes + 2 * kv_bytes + p * sqp * LD * 2;
      const uint32_t sdO = sO + q_bytes;

      // 1. per query strip: delta, S, P, dP, dS
      for (int strip = w0; strip < qs_n; strip += wpp) {
        // delta of the strip's 16 rows: lanes 2r and 2r + 1 split row r
        {
          const int r = strip * 16 + (lane >> 1);
          float acc = 0.f;
          for (int c = 2 * (lane & 1); c < D; c += 4) {
            const uint32_t a = ld_shared_u32(sO + (r * LD + c) * 2);
            const uint32_t d = ld_shared_u32(sdO + (r * LD + c) * 2);
            acc = fmaf(__uint_as_float(a << 16), __uint_as_float(d << 16),
                       acc);
            acc = fmaf(__uint_as_float(a & 0xffff0000u),
                       __uint_as_float(d & 0xffff0000u), acc);
          }
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          if ((lane & 1) == 0) st_shared_u32(sDelta + r * 4, __float_as_uint(acc));
        }
        __syncwarp();

        const uint32_t qa = a_rows(sQ + strip * 16 * LD * 2, LD, lane);
        const uint32_t da = a_rows(sdO + strip * 16 * LD * 2, LD, lane);
        const uint32_t kb = b_rows(sK, LD, lane), vb = b_rows(sV, LD, lane);
        float sc[8][4], dp[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks) {
          uint32_t aq[4], ad[4];
          ldsm_x4(aq, qa + ks * 32);
          ldsm_x4(ad, da + ks * 32);
#pragma unroll
          for (int n2 = 0; n2 < kSbMaxS / 16; ++n2) {
            if (n2 < ks_n) {
              uint32_t r[4];
              ldsm_x4(r, kb + (n2 * 16 * LD + ks * 16) * 2);
              const uint32_t k0f[2] = {r[0], r[1]}, k1f[2] = {r[2], r[3]};
              mma_16816(sc[2 * n2], aq, k0f);
              mma_16816(sc[2 * n2 + 1], aq, k1f);
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
            const float x = col < Sk ? sc[nt][e] * scale_log2e : -INFINITY;
            sc[nt][e] = x;
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
            const float pv = exp2f(sc[nt][e] - mx[e >> 1]);  // masked -> 0
            sc[nt][e] = pv;
            l[e >> 1] += pv;
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
        // P and dS = P (dP - delta) to the pair's bf16 tiles
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt < skp / 8) {
            float pv[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pv[e] = sc[nt][e] * inv[e >> 1];
              ds[e] = pv[e] * (dp[nt][e] - dl[e >> 1]);
            }
            const int off = ((strip * 16 + g) * LP + nt * 8 + 2 * t) * 2;
            st_shared_u32(sP + off, pack_f32(pv[0], pv[1]));
            st_shared_u32(sP + off + 8 * LP * 2, pack_f32(pv[2], pv[3]));
            st_shared_u32(sdS + off, pack_f32(ds[0], ds[1]));
            st_shared_u32(sdS + off + 8 * LP * 2, pack_f32(ds[2], ds[3]));
          }
        }
      }
      pair_sync();  // every strip's P and dS are in the pair's tiles

      // 2. dq = scale dS k per query strip
      const uint32_t kt = bt_rows(sK, LD, lane);
      for (int strip = w0; strip < qs_n; strip += wpp) {
        const uint32_t dsa = a_rows(sdS + strip * 16 * LP * 2, LP, lane);
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
        for (int j = 0; j < kSbMaxS / 16; ++j) {
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
        store_rows<NT>(dq + b * st.s[kDQ][0] + h * st.s[kDQ][1],
                       st.s[kDQ][2], acc, scale, strip * 16, Sq, D, lane);
        __syncwarp();  // store_rows diverges; ldmatrix needs the warp whole
      }

      // 3. dv = P^T dO and dk = scale dS^T q per 16-key strip
      const uint32_t dot = bt_rows(sdO, LD, lane), qt = bt_rows(sQ, LD, lane);
      for (int which = 0; which < 2; ++which) {
        const uint32_t src = which == 0 ? sP : sdS;
        const uint32_t rhs = which == 0 ? dot : qt;
        uint16_t* out = which == 0 ? dv + b * st.s[kDV][0] + h * st.s[kDV][1]
                                   : dk + b * st.s[kDK][0] + h * st.s[kDK][1];
        const long long rs = which == 0 ? st.s[kDV][2] : st.s[kDK][2];
        for (int strip = w0; strip < ks_n; strip += wpp) {
          const uint32_t pa = at_rows(src, LP, lane) + strip * 16 * 2;
          float acc[NT][4];
#pragma unroll
          for (int n = 0; n < NT; ++n)
            acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
          for (int j = 0; j < kSbMaxS / 16; ++j) {
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
          store_rows<NT>(out, rs, acc, which == 0 ? 1.f : scale, strip * 16,
                         Sk, D, lane);
          __syncwarp();
        }
      }
      pair_sync();  // the next unit rewrites the pair's P, dS and delta
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
}

// static: internal linkage, so the function-local statics below belong to
// this copy of the library (see small_seq_attn.cu's launch_small)
template <int DP>
static int launch_small_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, void* dq,
                            void* dk, void* dv, int B, int H, int Sq, int Sk,
                            int D, const long long* strides,
                            const BwdStrides& st, float scale_log2e,
                            cudaStream_t stream) {
  const SmallBwdPlan pl = small_bwd_plan(DP, H, Sq, Sk);
  if (pl.stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint32_t cols = sb_pitch(DP), heads = pl.pairs;
  const cuuint32_t qbox[4] = {cols, static_cast<cuuint32_t>(sb_pad16(Sq)),
                              heads, 1};
  const cuuint32_t kvbox[4] = {cols, static_cast<cuuint32_t>(sb_pad16(Sk)),
                               heads, 1};
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap tq, tk, tv, to, tdo;
  int rc = make_map(&tq, q, B, H, Sq, D, strides + 3 * kQ, qbox, sw);
  if (rc == 0) rc = make_map(&tk, k, B, H, Sk, D, strides + 3 * kK, kvbox, sw);
  if (rc == 0) rc = make_map(&tv, v, B, H, Sk, D, strides + 3 * kV, kvbox, sw);
  if (rc == 0) rc = make_map(&to, o, B, H, Sq, D, strides + 3 * kO, qbox, sw);
  if (rc == 0)
    rc = make_map(&tdo, dout, B, H, Sq, D, strides + 3 * kDO, qbox, sw);
  if (rc != 0) return rc;

  // per device, once: the SM count, and the shared-memory ceiling as the
  // kernel's dynamic shared-memory limit
  static int sm_count[kSbMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kSbMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  auto kern = small_seq_bwd_kernel<DP>;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSbCeiling));
    int sms = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_count[dev] = sms;
  }
  const int sms = sm_count[dev];
  const int smem = static_cast<int>(pl.stages * pl.slot_bytes +
                                    pl.pairs * sb_scratch_bytes(Sq, Sk)) +
                   kSbReserve;
  const long long units =
      static_cast<long long>(B) * ((H + pl.pairs - 1) / pl.pairs);
  const int grid = static_cast<int>(units < sms ? units : sms);
  kern<<<grid, 32 * (pl.pairs * pl.wpp + 1), smem, stream>>>(
      tq, tk, tv, to, tdo, static_cast<uint16_t*>(dq),
      static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), B, H, Sq, Sk, D,
      st, pl.pairs, pl.wpp, pl.stages, scale_log2e * 0.6931471805599453f,
      scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vv

// What the backward is built for: the padded head dims of the forward's
// trainer shapes (40, 80, 160; 72 pads to 80) and 1 <= Sq, Sk <= 64.
extern "C" int vv_small_seq_bwd_supported(int dp, int sq, int sk) {
  if (sq < 1 || sk < 1 || sq > vv::kSbMaxS || sk > vv::kSbMaxS) return 0;
  if (vv::small_bwd_plan(dp, 1, sq, sk).stages < 1) return 0;
  return dp == 48 || dp == 80 || dp == 160;
}

// q, k, v, o, dO, dq, dk, dv: bf16 (B, H, S, D) views with contiguous D
// (token-major operands as the (N, H, S, d) view of (N, S, H * d));
// strides holds their (sequence, head, row) strides in elements (24
// values); scale_log2e: the softmax scale times log2(e), as the forward
// takes it. Launches on `stream`, allocates nothing, returns 0, a CUDA
// error, or 1000 + the CUresult of a refused tensor map.
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
    case 48:  return vv::launch_small_bwd<48>(q, k, v, o, dout, dq, dk, dv, B, H, Sq, Sk, D, strides, st, scale_log2e, s);
    case 80:  return vv::launch_small_bwd<80>(q, k, v, o, dout, dq, dk, dv, B, H, Sq, Sk, D, strides, st, scale_log2e, s);
    case 160: return vv::launch_small_bwd<160>(q, k, v, o, dout, dq, dk, dv, B, H, Sq, Sk, D, strides, st, scale_log2e, s);
    default:  return static_cast<int>(cudaErrorInvalidValue);
  }
}
