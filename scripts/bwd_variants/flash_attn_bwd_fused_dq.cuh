// flash_attn_bwd with dQ folded into the dK/dV pass (FlashAttention-3's
// deterministic mode), for scripts/bwd_ablation.py's variant `fused_dq`:
// the script inserts this text at the end of flash_attn_bwd.cu's namespace
// vv and sends the D = 40 and D = 80 instances here. Not on the port's
// path: it is the alternative that PERF.md weighs against the separate dQ
// pass.
//
// Three launches: delta = rowsum(dO o O) (and the hand-over counters
// zeroed); the dK/dV pass of flash_attn_bwd.cu, where after each query
// block the consumer warpgroups store dS^T (bf16) to shared memory and
// one of them, in turn, computes the block's dQ tile = dS K (wgmma, both
// operands MN-major) into an f32 buffer; a writer warp adds that tile into
// an f32 dQ scratch with one bulk reduction, in key-block order: key
// block j waits until the block's counter reads j, adds (block 0 stores),
// waits for its writes to complete, and raises the counter. CTAs are
// launched key block fastest, so the block a CTA waits for was scheduled
// before it and never waits on a later one: no deadlock. Last, dQ is
// scaled into bf16.
//
// The caller's delta scratch must hold B*H*Sq*(1 + D) floats and then
// B*H*ceil(Sq/64) counters.

// both operands MN-major, from shared memory; `accumulate` = 0 overwrites
template <int N>
struct WgmmaSSTT;
template <>
struct WgmmaSSTT<40> {
  static __device__ __forceinline__ void mma(float (&d)[20], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, %20, %21, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaSSTT<80> {
  static __device__ __forceinline__ void mma(float (&d)[40], uint64_t da,
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

__device__ __forceinline__ uint32_t ld_acquire_u32(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// delta = rowsum(dO o O), 8 lanes a row (16 bytes each); zeroes counters
__global__ void __launch_bounds__(256)
fused_delta_kernel(const uint16_t* __restrict__ o,
                   const uint16_t* __restrict__ dout,
                   float* __restrict__ delta, uint32_t* __restrict__ counters,
                   long long n_counters, int H, int Sq, int D,
                   const BwdStrides st, long long rows) {
  const long long gt = blockIdx.x * 256ll + threadIdx.x;
  for (long long i = gt; i < n_counters; i += gridDim.x * 256ll)
    counters[i] = 0;
  const long long row = gt / 8;
  const int c = threadIdx.x % 8;
  float acc = 0.f;
  if (row < rows) {
    const int i = static_cast<int>(row % Sq);
    const long long bh = row / Sq;
    const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
    for (int cc = c; cc * 8 < D; cc += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          o + b * st.s[kO][0] + h * st.s[kO][1] + i * st.s[kO][2] + cc * 8);
      const uint4 y = *reinterpret_cast<const uint4*>(
          dout + b * st.s[kDO][0] + h * st.s[kDO][1] + i * st.s[kDO][2] +
          cc * 8);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc = fmaf(__uint_as_float(xs[e] << 16),
                   __uint_as_float(ys[e] << 16), acc);
        acc = fmaf(__uint_as_float(xs[e] & 0xffff0000u),
                   __uint_as_float(ys[e] & 0xffff0000u), acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < rows && c == 0) delta[row] = acc;
}

// dq = scale * the f32 scratch (B*H*Sq rows of D), bf16 into dq's strides
__global__ void __launch_bounds__(256)
fused_dq_convert_kernel(const float* __restrict__ acc,
                        uint16_t* __restrict__ dq, int H, int Sq, int D,
                        long long sb, long long sh, long long ss, float scale,
                        long long pairs) {
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  if (i >= pairs) return;
  const long long row = i / (D / 2);
  const int c = static_cast<int>(i % (D / 2)) * 2;
  const int q = static_cast<int>(row % Sq);
  const long long bh = row / Sq;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const float2 v = *reinterpret_cast<const float2*>(acc + row * D + c);
  *reinterpret_cast<uint32_t*>(dq + b * sb + h * sh + q * ss + c) =
      pack_f32(v.x * scale, v.y * scale);
}

template <int DK, int DN, int NWG, int BS, int STAGES>
struct FusedCfg : BwdCfg<DK, DN, NWG, BS, STAGES> {
  using B = BwdCfg<DK, DN, NWG, BS, STAGES>;
  static constexpr int NB = 2;                    // dQ tile buffers
  static constexpr int DS_BYTES = B::BR * BS * 2;  // dS^T, BR keys x BS
  static constexpr int DQ_BYTES = BS * DN * 4;     // one f32 dQ tile
  static constexpr int SMEM = 1024 + 2 * B::RES_BYTES +
                              STAGES * (2 * B::STR_BYTES + 2 * BS * 4) +
                              2 * DS_BYTES + NB * DQ_BYTES +
                              8 * (1 + 2 * STAGES + 2 * NB);
  static_assert(BS == 64, "dS^T rows are one 128-byte swizzled box");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int DK, int DN, int NWG, int BS, int STAGES>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                       float* __restrict__ dq_acc,
                       uint32_t* __restrict__ counters, int H, int Sq,
                       int Sk, int D, const BwdStrides st, float scale,
                       float scale_log2e) {
  using C = FusedCfg<DK, DN, NWG, BS, STAGES>;
  constexpr int BM = BS, NB = C::NB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + C::RES_BYTES;
  const uint32_t sRing = sV + C::RES_BYTES;
  const uint32_t sdS = sRing + STAGES * 2 * C::STR_BYTES;  // 2 buffers
  const uint32_t sdQ = sdS + 2 * C::DS_BYTES;              // NB buffers
  const uint32_t sStat = sdQ + NB * C::DQ_BYTES;
  const uint32_t bars = sStat + STAGES * 2 * BM * 4;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto dq_full = [&](int i) { return bars + 8 * (1 + 2 * STAGES + i); };
  auto dq_empty = [&](int i) { return bars + 8 * (1 + 2 * STAGES + NB + i); };
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
      mbar_init(full(s), 32);
      mbar_init(empty(s), NWG);
    }
    for (int i = 0; i < NB; ++i) {
      mbar_init(dq_full(i), 128);
      mbar_init(dq_empty(i), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    if constexpr (NWG > 1) reg_dealloc<C::PROD>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 == 4 * NWG + 1) {
      // ---- writer: the dQ tiles into the scratch, in key-block order ----
      if (lane != 0) return;
      for (int i = 0; i < n_qb; ++i) {
        const int bq = i % NB;
        mbar_wait(dq_full(bq), (i / NB) & 1);
        uint32_t* cnt = counters + static_cast<long long>(bh) * n_qb + i;
        if (blockIdx.x > 0) {
          while (ld_acquire_u32(cnt) != blockIdx.x) {
          }
          asm volatile("fence.proxy.async.global;" ::: "memory");
        }
        const int rows = Sq - i * BM < BM ? Sq - i * BM : BM;
        float* dst = dq_acc + (static_cast<long long>(bh) * Sq + i * BM) * D;
        const uint32_t bytes = rows * D * 4;
        if (blockIdx.x == 0)
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
              ::"l"(dst), "r"(sdQ + bq * C::DQ_BYTES), "r"(bytes)
              : "memory");
        else
          asm volatile(
              "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
              "[%0], [%1], %2;" ::"l"(dst), "r"(sdQ + bq * C::DQ_BYTES),
              "r"(bytes) : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
        asm volatile("fence.proxy.async.global;" ::: "memory");
        asm volatile("fence.acq_rel.gpu;" ::: "memory");
        asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;" ::"l"(cnt)
                     : "memory");
        mbar_arrive(dq_empty(bq));
      }
      return;
    }
    if (threadIdx.x / 32 != 4 * NWG) return;
    // ---- producer: as flash_bwd_dkdv_kernel's ----
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
        const bool ok = row < Sq;
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

  // ---- consumers: as flash_bwd_dkdv_kernel's, plus the dQ tiles ----
  if constexpr (NWG > 1) reg_alloc<C::CONS>();
  constexpr int RS = BM / 2, RO = DN / 2, KS = BM / 16;
  const int t = threadIdx.x % 128, c4 = t % 4;
  const int warp = t / 32, g = (t % 32) / 4;
  const uint32_t kw = sK + wg * 64 * 128, vw = sV + wg * 64 * 128;

  float acc_dk[RO], acc_dv[RO], acc_s[RS], acc_dp[RS];
#pragma unroll
  for (int i = 0; i < RO; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  fence_regs(acc_dk);
  fence_regs(acc_dv);
  uint32_t pa[KS][4], dsa[KS][4];

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

  mbar_wait(kv_full, 0);
  for (int i = 0; i <= n_qb; ++i) {
    const int s = i % STAGES, sp = (i + STAGES - 1) % STAGES;
    if (i < n_qb) mbar_wait(full(s), (i / STAGES) & 1);
    pp.turn();
    wgmma_fence();
    if (i < n_qb) mma_sdp(s);
    if (i > 0) mma_dkdv(sp);
    wgmma_commit();
    pp.hand_over(i == n_qb);
    wgmma_wait<0>();
    fence_regs(acc_s);
    fence_regs(acc_dp);
    if (i > 0 && t == 0) mbar_arrive(empty(sp));
    if (i == n_qb) break;
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
    acc_to_a<KS>(pa, acc_s);
    acc_to_a<KS>(dsa, acc_dp);

    // dS^T (bf16; 0 on padded keys) to buffer i & 1, 128-byte swizzled
    // with the keys as rows: dQ's A operand, MN-major
    const uint32_t sdSb = sdS + (i & 1) * C::DS_BYTES;
#pragma unroll
    for (int x = 0; x < RS; x += 2) {
      const int row = wg * 64 + 16 * warp + g + 8 * ((x >> 1) & 1);
      const int col = (x / 4) * 8 + 2 * c4;
      const bool ok = k0 + row < Sk;
      st_shared_u32(sdSb + row * 128 +
                        ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) * 2)),
                    ok ? pack_f32(acc_dp[x], acc_dp[x + 1]) : 0u);
    }
    fence_proxy_async();
    named_bar_sync(8, 128 * NWG);  // all keys' dS^T are in
    if (i % NWG == wg) {
      // dQ tile = dS K over the CTA's BR keys, into f32 buffer i % NB
      const int bq = i % NB;
      mbar_wait(dq_empty(bq), ((i / NB) & 1) ^ 1);
      float acc_q[RO];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BR / 16; ++kk)
        WgmmaSSTT<DN>::mma(acc_q, desc_sw128(sdSb + kk * 2048, 8192, 1024),
                           desc_sw128(sK + kk * 2048, C::BR * 128, 1024),
                           kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_q);
      const uint32_t buf = sdQ + bq * C::DQ_BYTES;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
#pragma unroll
        for (int j = 0; j < DN / 8; ++j) {
          const int col = 8 * j + 2 * c4;
          if (col < D) {
            st_shared_u32(buf + (row * D + col) * 4,
                          __float_as_uint(acc_q[4 * j + 2 * r]));
            st_shared_u32(buf + (row * D + col + 1) * 4,
                          __float_as_uint(acc_q[4 * j + 2 * r + 1]));
          }
        }
      }
      fence_proxy_async();
      mbar_arrive(dq_full(bq));
    }
  }
  fence_regs(acc_dv);
  fence_regs(acc_dk);

  const int row0 = k0 + wg * 64;
  store_acc<DN>(dk + b * st.s[kDK][0] + h * st.s[kDK][1], st.s[kDK][2],
                acc_dk, scale, row0, Sk, D, t);
  store_acc<DN>(dv + b * st.s[kDV][0] + h * st.s[kDV][1], st.s[kDV][2],
                acc_dv, 1.f, row0, Sk, D, t);
}

template <int DK, int DN, int NWG, int ST>
static int flash_bwd_fused(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, void* dq, void* dk, void* dv, int B,
                           int H, int Sq, int Sk, int D,
                           const long long* strides, const BwdStrides& st,
                           float scale_log2e, cudaStream_t stream) {
  using C = FusedCfg<DK, DN, NWG, 64, ST>;
  const float scale = scale_log2e * 0.6931471805599453f;
  const long long rows = static_cast<long long>(B) * H * Sq;
  const long long n_counters = static_cast<long long>(B) * H * ((Sq + 63) / 64);
  float* dq_acc = delta + rows;
  uint32_t* counters = reinterpret_cast<uint32_t*>(dq_acc + rows * D);
  fused_delta_kernel<<<static_cast<unsigned>((rows * 8 + 255) / 256), 256, 0,
                       stream>>>(static_cast<const uint16_t*>(o),
                                 static_cast<const uint16_t*>(dout), delta,
                                 counters, n_counters, H, Sq, D, st, rows);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint32_t res[4] = {64, C::BR, 1, 1}, str[4] = {64, 64, 1, 1};
  CUtensorMap tq, tk, tv, tdo;
  rc = make_map(&tq, q, B, H, Sq, D, strides + 3 * kQ, str, sw);
  if (rc == 0) rc = make_map(&tdo, dout, B, H, Sq, D, strides + 3 * kDO, str, sw);
  if (rc == 0) rc = make_map(&tk, k, B, H, Sk, D, strides + 3 * kK, res, sw);
  if (rc == 0) rc = make_map(&tv, v, B, H, Sk, D, strides + 3 * kV, res, sw);
  if (rc != 0) return rc;
  auto kern = flash_bwd_fused_kernel<DK, DN, NWG, 64, ST>;
  rc = set_smem(kern, C::SMEM);
  if (rc != 0) return rc;
  kern<<<dim3((Sk + C::BR - 1) / C::BR, B * H), C::THREADS, C::SMEM,
         stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<uint16_t*>(dk),
                   static_cast<uint16_t*>(dv), dq_acc, counters, H, Sq, Sk,
                   D, st, scale, scale_log2e);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const long long pairs = rows * D / 2;
  fused_dq_convert_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256,
                            0, stream>>>(dq_acc, static_cast<uint16_t*>(dq),
                                         H, Sq, D, st.s[kDQ][0], st.s[kDQ][1],
                                         st.s[kDQ][2], scale, pairs);
  return static_cast<int>(cudaGetLastError());
}
