// Attention forward on Hopper's warpgroup tensor cores (sm_90a) at the
// VAE's head dimension D = 512: K2 in the online mode.
//
// Replaces, on the paths, the TPU kernel of
// prompt_diffusion_tpu/ops/flash_attention.py:
//   * flash_attention (:163, pallas_call :105, `_fa_kernel` :35), (B, N, H,
//     D) attention with no mask, at D = 512: the VAE mid-block attention of
//     the SD1.5 and SD3 decodes and the VAE encodes.
// Its parent, `fa_wide_kernel` (flash_attention.cu), issues Ampere's
// mma.sync from ldmatrix fragments over a cp.async ring, 16 warps in
// lockstep with three block barriers a 32-key tile, the partial logits and
// P through shared memory; it stays as the kernel of the head dims above
// 128 that no path runs (D = 160) and as the parent design that
// tools/attn_tune.py --part wide times beside this one.
//
// Numerics, as attention_sm90.cuh's: fp32 logits, running max and running
// sum; the row maximum over the unscaled logits, scaled once (scale > 0,
// checked); each probability one FFMA into ex2, p = 2^(s * c - m) with c =
// scale * log2(e); P rounded to bf16 against the running maximum; the sum
// over the fp32 P; O rescaled only when a row maximum of the warp moved;
// one division at the end. The key tile (32 keys) and the sum of the two
// half-depth partial logits (below) are what move where a rounding falls.
//
// What bounds it on the H100: the two products, 4 N^2 D operations a
// (batch, head), 8x the exponentials' time at D = 512. What this design
// does about it, from three facts of the card at this width:
//   * O splits by columns. A 64 x 512 fp32 O is 128 KB, half the register
//     file: two consumer warpgroups own the same 64 query rows and 256 of
//     O's columns each (128 fp32 registers a thread; wgmma's N stops at
//     256), one producer warpgroup issues the TMA copies, `setmaxnreg`
//     gives it 40 registers a thread and each consumer 232. An SM holds O
//     for one 64-row group only;
//   * the logits are shared by a depth split: consumer c computes the
//     partial S_c = Q[:, 256c : 256c + 256] . K_j[:, 256c : 256c + 256]^T of
//     tile j (`wgmma` m64n32k16, Q and K from shared memory), the two
//     partials cross through shared memory (double-buffered, one named
//     barrier of both consumers a tile), and each consumer adds them, S_0 +
//     S_1 (fp32 addition commutes: both get the same bits), and runs the
//     same softmax. So each consumer holds the whole P of the tile in
//     registers, and its P.V is `wgmma` m64n256k16 with P as the register A
//     operand and its 256 columns of V as the MN-major B operand. The
//     exponentials are taken twice (once per consumer), at 1/4 of the
//     products' time;
//   * one CTA a 64-row query block, each reading all of K and V from L2.
//     At 64 query rows a K/V byte feeds 64 multiply-adds, so the tensor-core
//     bound would need ~15.5 TB/s of K and V from L2; the card's L2 reads
//     9.25-9.74 TB/s (tools/attn_tune.py's probe), and 8.6 GB per SD3 call
//     at 1.23 ms is ~7 TB/s, so the L2 is not what binds (below). Sharing
//     each tile across a cluster of CTAs by TMA multicast was built and
//     timed, and dropped (below);
//   * shared memory (227 KB a block): Q (64 rows x 8 column blocks, 64 KB),
//     two stages of 32-key K and V tiles (64 KB a stage), the two
//     consumers' partial logits in two buffers (32 KB); every tile row is
//     one 128-byte swizzle span, the 4-D tensor maps over (D, N, H, B) of
//     attention_sm90.cuh (TMA zero-fills rows past N). One producer thread
//     issues Q and the K tiles, another the V tiles, each at its own pace.
// The loop of a consumer is attention_sm90.cuh's: tile j's Q.K^T and then
// tile j - 1's P.V issued as one turn, the wait for Q.K^T alone, the
// exchange, the softmax, the wait for the P.V (ptxas places it among the
// exponentials: SASS `WARPGROUP.DEPBAR` after ~9 of the 18 `MUFU.EX2`), O
// rescaled, P to bf16; the masked last tile (ragged N) is a separate
// instantiation of the step. No ping-pong: the depth split keeps the two
// consumers in lockstep.
//
// Measured on the H100 (tools/attn_tune.py --part wide; device ms at the SD3
// VAE's (1,16384,1,512) and the SD1.5 VAE's (4,4096,1,512), NVIDIA H100 80GB
// HBM3, 700 W; the parent 3.08-3.11 and 0.79-0.80, SDPA 4.46-4.56 and
// 1.11-1.15, the bound 0.556 and 0.139): this design 1.22-1.29 and 0.34-0.35.
// Designs timed against this one and not kept: clusters of 2 and of 4 CTAs
// on consecutive query blocks of a (batch, head), each CTA's producer
// multicasting its share of every K and V tile's column blocks to the
// cluster, a stage released by remote mbarrier arrivals of every consumer
// warp of the cluster (1.20-1.31 and 0.35 in clusters of 2: nothing bought;
// 1.89-2.01 and 0.46-0.54 in clusters of 4: an SM's one CTA couples to its
// cluster's at every stage); tile j + 1's Q.K^T issued before tile j's
// exchange and softmax, into a second set of S registers (1.51 and 0.42:
// ptxas spills 80 bytes); the roles swapped each tile, one consumer
// computing the whole S and the softmax and writing bf16 P to shared memory
// for both P.V halves (`wgmma` with A from shared memory), one named barrier
// a tile handing P, corr and the running state over (2.12 and 0.57); Q.K^T
// as two independent accumulator chains (1.24-1.36 and 0.34-0.36); 240
// consumer registers (1.25-1.27 and 0.34); Q.K^T's descriptor offsets as
// immediates in the PTX (1.28-1.29 and 0.35). What binds (ablated copies,
// SD3 shape): taking out the Q.K^T products saves 33%, the exchange 6-23%,
// the K/V copies 9%, the P.V products 7-9%, the exponentials nothing.
//
// One build-time switch, PD_SM90_ABLATE, is for tools/attn_tune.py's
// ablated copies: it takes a part out (1 the exponentials, 2 the P.V
// products, 4 the K/V copies after the first stages, 32 the exchange of the
// partial logits, 64 the Q.K^T products); an ablated copy's output is wrong
// by design.

#pragma once

#include "attention_sm90.cuh"

namespace pd_sm90 {

constexpr int WIDE_D = 512;       // the head dimension it takes
constexpr int WIDE_ROWS = 64;     // query rows of a CTA
constexpr int WIDE_BK = 32;       // keys of a tile
constexpr int WIDE_NC = 2;        // consumer warpgroups, WIDE_D / WIDE_NC columns of O each
constexpr int WIDE_COLS = WIDE_D / WIDE_NC;
constexpr int WIDE_BLOCKS = 2 * WIDE_D / SPAN;  // 128-byte column blocks of a row: 8
constexpr int WIDE_THREADS = 128 * (1 + WIDE_NC);
constexpr int ABL_NO_EXCHANGE = 32, ABL_NO_QK = 64;

// Shared memory of a CTA: Q, NS K stages, NS V stages, then the partial
// logits [buffer][consumer][BK / 8][128 threads] of float4; every part
// 1024-byte aligned; the mbarriers are static.
struct WidePlan {
  static constexpr int Q_BYTES = WIDE_BLOCKS * WIDE_ROWS * SPAN;    // 65536
  static constexpr int K_STAGE = WIDE_BLOCKS * WIDE_BK * SPAN;      // 32768
  static constexpr int V_STAGE = K_STAGE;
  static constexpr int X_PART = WIDE_BK / 2 * 128 * 4;              // one consumer's partial S: 8192
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + NS * K_STAGE;
  static constexpr int OFF_X = OFF_V + NS * V_STAGE;
  static constexpr int SMEM = OFF_X + 2 * WIDE_NC * X_PART + 1024;  // 230400
  static constexpr int KSTEPS = WIDE_D / 16 / WIDE_NC;              // k16 steps of a half-depth S: 16
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  static_assert(producer_regs(WIDE_NC) * 128 + consumer_regs(WIDE_NC) * 128 * WIDE_NC <= 65536,
                "registers");
};

// ---- wgmma: the two products of this width ----------------------------------------

// d (64 x 32) = or += A (64 x 16, shared) * B (32 x 16, shared, K-major)^T, bf16 into fp32
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
               : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 256) += A (64 x 16, registers) * B (16 x 256, shared, MN-major), bf16 into fp32
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                   "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                   "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
                   "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
                   "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
                   "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
                   "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
                   "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
                   "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
                   "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
                   "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
                   "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
                   "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
                   "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
                   "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
                   "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
                   "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
                   "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
                   "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
                   "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
                   "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
                   "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
                   "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the kernel ------------------------------------------------------------------

__global__ void __launch_bounds__(WIDE_THREADS, 1)
    attn_sm90_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = WidePlan;
  constexpr int BK = WIDE_BK, CT = 128 * WIDE_NC;  // keys of a tile, consumer threads
  constexpr int NS8 = BK / 8;        // 8-key column tiles of S
  constexpr int NO = WIDE_COLS / 8;  // 8-column tiles of a consumer's O
  constexpr int NP = BK / 16;        // k16 steps of P.V
  constexpr int KE = SPAN / 2;       // values of a column block row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * NS];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t q_full = bar0;
  auto full_k = [&](int s) { return bar0 + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar0 + 8 * (1 + NS + s); };
  auto empty_k = [&](int s) { return bar0 + 8 * (1 + 2 * NS + s); };
  auto empty_v = [&](int s) { return bar0 + 8 * (1 + 3 * NS + s); };
  auto k_tile = [&](int s) { return s_base + L::OFF_K + s * L::K_STAGE; };
  auto v_tile = [&](int s) { return s_base + L::OFF_V + s * L::V_STAGE; };

  const int q0 = blockIdx.x * WIDE_ROWS;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int nkt = (p.nk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);  // every consumer warp
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- the producer: lane 0 of warp 0 issues Q and the K tiles, lane 0
    // of warp 1 the V tiles, each at its own pace
    setmaxnreg_dec<producer_regs(WIDE_NC)>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int qb = 0; qb < WIDE_BLOCKS; ++qb) {
        tma_load(s_base + qb * WIDE_ROWS * SPAN, &tq, q_full, qb * KE, q0, h, b);
      }
    }
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      const bool is_k = threadIdx.x == 0;
      const CUtensorMap* map = is_k ? &tk : &tv;
      for (int j = 0; j < nkt; ++j) {
        const int s = j % NS;
        const uint32_t full = is_k ? full_k(s) : full_v(s);
        const uint32_t dst = is_k ? k_tile(s) : v_tile(s);
        mbar_wait(is_k ? empty_k(s) : empty_v(s), ((j / NS) & 1) ^ 1);  // the first round finds the stages free
        if ((ABLATE & ABL_NO_COPY) && j >= NS) {
          mbar_arrive(full);
          continue;
        }
        mbar_expect_tx(full, L::K_STAGE);
#pragma unroll
        for (int cb = 0; cb < WIDE_BLOCKS; ++cb) {
          tma_load(dst + cb * BK * SPAN, map, full, cb * KE, j * BK, h, b);
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup c owns columns 256 c .. 256 c + 255 of O,
  // all 64 rows
  setmaxnreg_inc<consumer_regs(WIDE_NC)>();
  const int tid = threadIdx.x - 128;
  const int c = tid >> 7, ct = tid & 127;
  const int warp = ct >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const float kf = p.scale * LOG2E;
  // a stage released: one arrival of this warp on the stage's empty barrier
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float s[BK / 2];         // S of the tile in flight: row g + 8 (i / 2 % 2), key 8 (i / 4) + 2t + i % 2
  uint32_t pa[NP][4];      // bf16 P of the previous tile, P.V's A fragments
  float o[WIDE_COLS / 2];  // O: row g + 8 (i / 2 % 2), column 256 c + 8 (i / 4) + 2t + i % 2
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WIDE_COLS / 2; ++i) o[i] = 0.f;
  mbar_wait(q_full, 0);

  // S_c of tile j (64 x 32) = Q . K_j^T over this consumer's half of the depth
  auto issue_qk = [&](int j) {
    const int stage = j % NS;
    mbar_wait(full_k(stage), (j / NS) & 1);
    fence_regs(s);
    wgmma_fence();
    if (!(ABLATE & ABL_NO_QK)) {
#pragma unroll
      for (int ks = 0; ks < L::KSTEPS; ++ks) {
        const int kk = c * L::KSTEPS + ks;  // k16 step of the whole depth
        wgmma_ss_bf16(s, desc_sw128(s_base + (kk >> 2) * WIDE_ROWS * SPAN + (kk & 3) * 32, 16),
                      desc_sw128(k_tile(stage) + (kk >> 2) * BK * SPAN + (kk & 3) * 32, 16),
                      ks > 0);
      }
    }
    wgmma_commit();
  };
  // this consumer's columns of V_stage as P.V's B operand, k16 step kk
  auto v_desc = [&](int stage, int kk) {
    return desc_sw128(v_tile(stage) + (WIDE_BLOCKS / WIDE_NC) * c * BK * SPAN + kk * 16 * SPAN,
                      BK * SPAN);
  };
  auto issue_pv = [&](int stage) {
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    if (!(ABLATE & ABL_NO_PV)) {
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) wgmma_rs_bf16(o, pa[kk], v_desc(stage, kk));
    }
    wgmma_commit();
  };
  // tile j's logits in s to probabilities (fp32, in place), the new row
  // maxima and sums; corr: the factor of the rows' earlier O. The key tail
  // (`masked`, the last tile) is masked by selects in a separate
  // instantiation.
  auto softmax = [&](int j, float (&corr)[2], auto masked) {
    if constexpr (decltype(masked)::value) {  // the key tail to -inf
#pragma unroll
      for (int n = 0; n < NS8; ++n) {
        const int col = j * BK + n * 8 + 2 * t;
        const bool out0 = col >= p.nk, out1 = col + 1 >= p.nk;
        s[4 * n] = out0 ? -INFINITY : s[4 * n];
        s[4 * n + 2] = out0 ? -INFINITY : s[4 * n + 2];
        s[4 * n + 1] = out1 ? -INFINITY : s[4 * n + 1];
        s[4 * n + 3] = out1 ? -INFINITY : s[4 * n + 3];
      }
    }
    float r0[NS8], r1[NS8];
#pragma unroll
    for (int n = 0; n < NS8; ++n) {
      r0[n] = fmaxf(s[4 * n], s[4 * n + 1]);
      r1[n] = fmaxf(s[4 * n + 2], s[4 * n + 3]);
    }
    const float mx[2] = {
        fmaxf(m[0], quad_max(fmaxf(fmaxf(r0[0], r0[1]), fmaxf(r0[2], r0[3]))) * kf),
        fmaxf(m[1], quad_max(fmaxf(fmaxf(r1[0], r1[1]), fmaxf(r1[2], r1[3]))) * kf)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      corr[r] = ex2(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NS8; ++n) {  // p = 2^(s * c - m), one FFMA
      const float p0 = ex2(fmaf(s[4 * n], kf, -m[0]));
      const float p1 = ex2(fmaf(s[4 * n + 1], kf, -m[0]));
      const float p2 = ex2(fmaf(s[4 * n + 2], kf, -m[1]));
      const float p3 = ex2(fmaf(s[4 * n + 3], kf, -m[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      s[4 * n] = p0;
      s[4 * n + 1] = p1;
      s[4 * n + 2] = p2;
      s[4 * n + 3] = p3;
    }
  };
  static_assert(NS8 == 4, "the row maxima take four 8-key tiles");
  // O *= corr where a row maximum of the warp moved (exact elsewhere: corr = 1)
  auto rescale = [&](const float (&corr)[2]) {
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[4 * n] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
    }
  };
  // P to bf16 A fragments: 8-key tiles 2kk and 2kk + 1 are k16 step kk
  auto to_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  const bool ragged = p.nk % BK != 0;  // the last tile holds the key tail
  float corr[2];

  // the partial logits: this thread's float4 i of consumer cc in buffer x
  auto part = [&](int x, int cc, int i) {
    return reinterpret_cast<float4*>(smem + L::OFF_X + (x * WIDE_NC + cc) * L::X_PART) + i * 128 +
           ct;
  };
  // tile j's partial logits to the other consumer and theirs added: S_0 + S_1
  auto exchange = [&](int j) {
    if (ABLATE & ABL_NO_EXCHANGE) return;
    const int x = j & 1;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      *part(x, c, i) = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    }
    named_sync<CT>(1);
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float4 other = *part(x, c ^ 1, i);
      s[4 * i] += other.x;
      s[4 * i + 1] += other.y;
      s[4 * i + 2] += other.z;
      s[4 * i + 3] += other.w;
    }
  };
  // tile 0: S only
  issue_qk(0);
  wgmma_wait<0>();
  fence_regs(s);
  release(empty_k(0));
  exchange(0);
  if (ragged && nkt == 1) {
    softmax(0, corr, Flag<true>());
  } else {
    softmax(0, corr, Flag<false>());
  }
  to_p();
  // tile j: S_j, then P_{j-1} V_{j-1} behind it; the exchange and the
  // softmax of S_j while that product runs
  auto step = [&](int j, auto masked) {
    const int st = j % NS, prev = (j - 1) % NS;
    issue_qk(j);
    mbar_wait(full_v(prev), ((j - 1) / NS) & 1);
    issue_pv(prev);
    wgmma_wait<1>();
    fence_regs(s);
    release(empty_k(st));
    exchange(j);
    softmax(j, corr, masked);
    wgmma_wait<0>();  // the P.V in flight, then O *= corr
    fence_regs(o);
    fence_regs(pa);
    rescale(corr);
    release(empty_v(prev));
    to_p();
  };
  for (int j = 1; j < nkt - 1; ++j) step(j, Flag<false>());
  if (nkt > 1) {
    if (ragged) {
      step(nkt - 1, Flag<true>());
    } else {
      step(nkt - 1, Flag<false>());
    }
  }
  {  // the last P.V
    const int last = (nkt - 1) % NS;
    mbar_wait(full_v(last), ((nkt - 1) / NS) & 1);
    issue_pv(last);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(empty_v(last));
  }

  // O / l, stored as bf16 pairs straight from the accumulators
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= p.nq) continue;
    __nv_bfloat16* orow =
        p.o + b * p.o_sb + static_cast<int64_t>(qi) * p.o_sn + h * p.o_sh + c * WIDE_COLS;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] / l[r], o[4 * n + 2 * r + 1] / l[r]);
    }
  }
}

// The launch: the grid is (ceil(Nq / 64), B * H); internal linkage, as
// attention_sm90.cuh's `launch`, for the once-only shared-memory attribute.
static int launch_wide(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                       const Params& p, int batch, cudaStream_t stream) {
  using L = WidePlan;
  void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const Params) =
      attn_sm90_wide_kernel;
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  const dim3 grid((p.nq + WIDE_ROWS - 1) / WIDE_ROWS, batch * p.heads);
  kernel<<<grid, WIDE_THREADS, L::SMEM, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pd_sm90
