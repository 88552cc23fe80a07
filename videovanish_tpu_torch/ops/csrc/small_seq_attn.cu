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
// with 1 <= Sq, Sk <= 64. The TPU kernels packed 128 // S sequences into one
// MXU tile under a block-diagonal mask; that is MXU packing and is not
// carried over.
//
// What bounds it on an H100: bytes. A (sequence, head) pair reads S*D*3 and
// writes S*D bf16 values and does 4*S*S*D flops: at S = 22 that is 11 flops
// a byte, against the ~295 the card does per byte of device memory. So q, k,
// v and o should cross device memory once each, at full rate, and the
// design is about keeping enough bytes in flight:
//   * units and persistent CTAs: a unit is one sequence times PAIRS
//     consecutive heads (whole 640-byte token rows at D = 40). One CTA per
//     SM walks units u = blockIdx.x + i * gridDim.x, head groups fastest, so
//     the heads of one token row are read by neighbouring CTAs at the same
//     time and the 32-byte sectors two heads share (D = 40: 80-byte head
//     slices) come from L2 the second time;
//   * asynchronous copies in a ring: one producer thread loads each unit's
//     q, k and v with three TMA loads (cp.async.bulk.tensor over 4-D maps of
//     the (B, S, H, D) storage; boxes of LD columns x S padded to 16 rows x
//     PAIRS heads) into a ring of STAGES slots with full and empty
//     mbarriers, and runs ahead by up to STAGES units. TMA zero-fills rows
//     past S, columns past D and heads past H without reading them, so the
//     padding costs no bytes and no instructions, and nothing past the last
//     head is read. A slot holds PAIRS x (Sq + 2 Sk, padded) x LD x 2 bytes,
//     PAIRS is the most heads of which 3 slots fit, and the ring takes as
//     many slots as fit: at S = 22, 8 heads (72 KB) at D = 40, 4 (60 KB) at
//     D = 80, 2 (65 KB) at D = 160, 3 slots each, one CTA of up to 9 warps
//     per SM. Consumer warps never issue a global load. Two slots measured
//     as fast as three or six;
//   * row pitch LD (small_pitch): DP, or DP + 8 where DP * 2 bytes is a
//     multiple of 64 (DP = 160), since there the 8 rows of one ldmatrix
//     phase would fall in 2 of the 8 bank groups;
//   * products stay on mma.sync m16n8k16 (bf16 in, f32 accumulate) with
//     fragments from ldmatrix (.trans for V). Not wgmma: one pair's product
//     is 22 x 32 x D, far under wgmma's 64-row tile; packing sequences into
//     64 rows under a block-diagonal mask would waste most of the tensor
//     work, and that work is not what bounds the kernel;
//   * consumer warps: WPP warps share one pair's K and V and split its
//     16-row query strips (S = 64: 4 warps, one strip each, so the 176 pairs
//     of the mid block's spatial attention spread over the card), PAIRS x
//     WPP <= 8 warps a CTA. Per strip: scores, padded keys masked to -inf, a
//     full f32 softmax in registers with the scale folded into exp2, p v,
//     one division by the row sum (a zero sum is divided by 1, as on the
//     TPU);
//   * stores: a strip's output is staged in bf16 over its own (consumed)
//     query rows and written as whole rows with 16-byte stores into the
//     (B, S, H, D) output, so merging heads stays a view.
#include <cuda.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace vv {

constexpr int kSmallMaxS = 64;
constexpr int kSmallWarps = 8;       // consumer warps of a CTA, at most
constexpr int kSmallMaxPairs = 8;    // heads of a unit, at most
constexpr int kSmallMaxStages = 8;   // ring slots, at most
constexpr long long kSmemCeiling = 232448;  // a block's shared memory on sm_90
constexpr int kSmallReserve = 256;   // alignment slack and the mbarriers
constexpr int kSmallMaxDevices = 64;

// Row pitch of a shared-memory tile, elements (DP is a multiple of 16).
// ldmatrix reads 8 rows of 16 bytes at a time: a pitch that is a multiple
// of 64 bytes puts 4 of them in one bank group (4-way conflicts), so it
// gets 16 more bytes; other dense pitches cost 2-way conflicts, which
// measured cheaper than padding (scripts/small_seq_ablation.py: at D = 80
// the padded pitch is 12% slower; at D = 40 it also keeps a unit from
// holding all 8 heads of a token row).
__host__ __device__ constexpr int small_pitch(int dp) {
  return dp % 32 == 0 ? dp + 8 : dp;
}

__host__ __device__ constexpr int pad16(int s) { return (s + 15) / 16 * 16; }

// one (sequence, head) pair's q, k and v tiles in a slot, bytes
inline long long small_pair_bytes(int dp, int sq, int sk) {
  return static_cast<long long>(pad16(sq) + 2 * pad16(sk)) * small_pitch(dp) *
         2;
}

struct SmallPlan {
  int pairs;   // heads per unit
  int wpp;     // consumer warps per pair
  int stages;  // ring slots
  long long slot_bytes;
};

// The largest unit (a power of two of heads, at most one per consumer warp
// and no more than H needs) of which three slots fit; as many warps per
// pair as fill kSmallWarps, at most one per query strip; as many slots as
// fit.
inline SmallPlan small_plan(int dp, int H, int sq, int sk) {
  const long long pair = small_pair_bytes(dp, sq, sk);
  const long long budget = kSmemCeiling - kSmallReserve;
  int pairs = kSmallMaxPairs;
  while (pairs > 1 && (pairs > kSmallWarps || pairs / 2 >= H ||
                       3 * pairs * pair > budget))
    pairs /= 2;
  int wpp = kSmallWarps / pairs;
  if (wpp > pad16(sq) / 16) wpp = pad16(sq) / 16;
  const long long slot = pairs * pair;
  long long stages = budget / slot;
  if (stages > kSmallMaxStages) stages = kSmallMaxStages;
  return {pairs, wpp, static_cast<int>(stages), slot};
}

// One 16-row query strip of one pair: q rows at sQ (shared, pitch LD), the
// pair's keys and values at sK and sV; the output rows row0.. go to ob
// (row stride oss) after staging over the strip's q rows.
template <int DP>
__device__ __forceinline__ void small_strip(uint32_t sQ, uint32_t sK,
                                            uint32_t sV, uint16_t* ob,
                                            long long oss, int row0, int Sq,
                                            int Sk, int D, int skp,
                                            float scale_log2e, int lane) {
  constexpr int LD = small_pitch(DP);
  constexpr int NT_O = DP / 8;
  constexpr int KS_D = DP / 16;
  const int g = lane >> 2, t = lane & 3;
  const int nt_s = skp / 8;   // score n-tiles (<= 8)
  const int ks_n = skp / 16;  // 16-key steps (<= 4)

  // S = Q K^T. A: lane gives row lane % 16 at column half lane / 16. B from
  // K rows: matrices (keys 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7),
  // (8-15, 8-15) of each 16-key block, i.e. b[0], b[1] of two n-tiles.
  const uint32_t qa = sQ + ((lane & 15) * LD + (lane >> 4) * 8) * 2;
  const uint32_t ka =
      sK + (((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8) * 2;
  float s[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS_D; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, qa + ks * 32);
#pragma unroll
    for (int n2 = 0; n2 < kSmallMaxS / 16; ++n2) {
      if (n2 < ks_n) {
        uint32_t kb[4];
        ldsm_x4(kb, ka + (n2 * 16 * LD + ks * 16) * 2);
        const uint32_t b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
        mma_16816(s[2 * n2], a, b0);
        mma_16816(s[2 * n2 + 1], a, b1);
      }
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * t + (e & 1);
      const float x =
          (nt < nt_s && col < Sk) ? s[nt][e] * scale_log2e : -INFINITY;
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

  // O = P V. A: P of key n-tiles 2ks and 2ks+1. B from V rows, transposed:
  // matrices (keys 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15),
  // i.e. b[0], b[1] of two output n-tiles.
  const uint32_t va =
      sV + ((((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8) * 2;
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
#pragma unroll
      for (int n2 = 0; n2 < NT_O / 2; ++n2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, va + (ks * 16 * LD + n2 * 16) * 2);
        const uint32_t b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
        mma_16816(oacc[2 * n2], a, b0);
        mma_16816(oacc[2 * n2 + 1], a, b1);
      }
    }
  }

  // stage the strip's output (bf16) over its q rows, which no one reads
  // again, then write whole rows with 16-byte stores
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    const uint32_t at = sQ + (g * LD + nt * 8 + 2 * t) * 2;
    st_shared_u32(at, pack_f32(oacc[nt][0] * l[0], oacc[nt][1] * l[0]));
    st_shared_u32(at + 8 * LD * 2,
                  pack_f32(oacc[nt][2] * l[1], oacc[nt][3] * l[1]));
  }
  __syncwarp();
  const int cpr = D / 8;  // 16-byte chunks of an output row
  for (int i = lane; i < 16 * cpr; i += 32) {
    const int r = i / cpr, c = i - r * cpr;
    if (row0 + r < Sq)
      *reinterpret_cast<uint4*>(ob + (row0 + r) * oss + c * 8) =
          ld_shared_v4(sQ + (r * LD + c * 8) * 2);
  }
  // the loop above diverges; the next strip starts with ldmatrix and
  // mma.sync, which need the whole warp converged
  __syncwarp();
}

template <int DP>
__global__ void __launch_bounds__(32 * (kSmallWarps + 1), 1)
small_seq_attn_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      uint16_t* __restrict__ o, int B, int H, int Sq, int Sk,
                      int D, long long osb, long long osh, long long oss,
                      int pairs, int wpp, int stages, float scale_log2e) {
  constexpr int LD = small_pitch(DP);
  const int sqp = pad16(Sq), skp = pad16(Sk);
  const uint32_t q_bytes = pairs * sqp * LD * 2;
  const uint32_t kv_bytes = pairs * skp * LD * 2;
  const uint32_t slot = q_bytes + 2 * kv_bytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  const uint32_t bars = base + stages * slot;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kSmallMaxStages + s); };

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
      }
    }
    return;
  }

  // ---- consumers: warp `warp` takes pair warp / wpp of every unit and
  // its query strips warp % wpp, + wpp, ... ----
  const int p = warp / wpp, w0 = warp % wpp;
  int i = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++i) {
    const int s = i % stages;
    mbar_wait(full(s), (i / stages) & 1);
    __syncwarp();  // converged before the .aligned ldmatrix / mma.sync
    const int b = u / head_groups, h = (u % head_groups) * pairs + p;
    if (h < H) {
      const uint32_t sQ = base + s * slot + p * sqp * LD * 2;
      const uint32_t sK = base + s * slot + q_bytes + p * skp * LD * 2;
      uint16_t* ob = o + b * osb + h * osh;
      for (int strip = w0; strip < sqp / 16; strip += wpp)
        small_strip<DP>(sQ + strip * 16 * LD * 2, sK, sK + kv_bytes, ob, oss,
                        strip * 16, Sq, Sk, D, skp, scale_log2e, lane);
    }
    // the staged output was written through the generic proxy; the next
    // TMA load into this slot writes through the async proxy
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
}

// static: internal linkage, so the function-local statics below belong to
// this copy of the library (the statics of an external template
// instantiation are one process-wide symbol, shared by every loaded copy)
template <int DP>
static int launch_small(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Sq, int Sk, int D,
                        const long long* st, float scale_log2e,
                        cudaStream_t stream) {
  const SmallPlan pl = small_plan(DP, H, Sq, Sk);
  if (pl.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint32_t cols = small_pitch(DP), heads = pl.pairs;
  const cuuint32_t qbox[4] = {cols, static_cast<cuuint32_t>(pad16(Sq)), heads,
                              1};
  const cuuint32_t kvbox[4] = {cols, static_cast<cuuint32_t>(pad16(Sk)),
                               heads, 1};
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, B, H, Sq, D, st, qbox, sw);
  if (rc == 0) rc = make_map(&tk, k, B, H, Sk, D, st + 3, kvbox, sw);
  if (rc == 0) rc = make_map(&tv, v, B, H, Sk, D, st + 6, kvbox, sw);
  if (rc != 0) return rc;

  // per device, once: the SM count, and the shared-memory ceiling as the
  // kernel's dynamic shared-memory limit (host calls that would otherwise
  // cost as much as the launch at the small shapes)
  static int sm_count[kSmallMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kSmallMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  auto kern = small_seq_attn_kernel<DP>;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemCeiling));
    int sms = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_count[dev] = sms;
  }
  const int sms = sm_count[dev];
  const int smem =
      static_cast<int>(pl.stages * pl.slot_bytes) + kSmallReserve;
  const long long units =
      static_cast<long long>(B) * ((H + pl.pairs - 1) / pl.pairs);
  const int grid = static_cast<int>(units < sms ? units : sms);
  kern<<<grid, 32 * (pl.pairs * pl.wpp + 1), smem, stream>>>(
      tq, tk, tv, static_cast<uint16_t*>(o), B, H, Sq, Sk, D, st[9], st[10],
      st[11], pl.pairs, pl.wpp, pl.stages, scale_log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vv

// Padded head dims this library is built for (the motion modules' 40/80/160;
// 72, Hiera's, pads to 80) and the sequence lengths it takes.
extern "C" int vv_small_seq_supported(int dp, int sq, int sk) {
  if (sq < 1 || sk < 1 || sq > vv::kSmallMaxS || sk > vv::kSmallMaxS) return 0;
  if (vv::small_plan(dp, 1, sq, sk).stages < 2) return 0;
  switch (dp) {
    case 48: case 80: case 160:
      return 1;
    default:
      return 0;
  }
}

// q/k/v/o: bf16 (B, H, S, D) views with contiguous D (token-major input is
// the (N, H, S, d) view of (N, S, H*d)); strides holds the (sequence, head,
// row) strides of q, k, v, o in elements (12 values). Launches on `stream`,
// allocates nothing, returns 0, a CUDA error, or 1000 + the CUresult of a
// refused tensor map.
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
