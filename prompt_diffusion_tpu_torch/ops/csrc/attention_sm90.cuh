// Attention forward on Hopper's warpgroup tensor cores (sm_90a): K1 and K2
// at head dimensions up to 128 (bf16), K9 (int8 Q.K^T, bf16 P.V), and the
// attention lab's online (L1), no-softmax (L2), two-pass (L3) and per-row-K
// int8 (L4) modes.
//
// Replaces, on the paths, the TPU kernels of
// prompt_diffusion_tpu/ops/flash_attention.py:
//   * flash_attention_packed (:322, pallas_call :280), packed (B, N, H*D)
//     self-attention (K1: the SD1.5 UNet and ControlNet at D = 40 and 80,
//     the DPT ViT-B and UniFormer at D = 64);
//   * flash_attention (:163, pallas_call :105), (B, N, H, D) attention (K2:
//     the MMDiT's joint attention under the bf16 policy, D = 64); K2 at
//     D = 512 (the VAE) runs attention_sm90_wide.cuh, which includes this
//     header for its helpers;
//   * flash_attention_packed_int8 (:375, pallas_call :402), int8 Q.K^T with
//     per-row Q and per-(batch, head) K scales (K9: the SD3 MMDiT and
//     ControlNet, DPT ViT-B and UniFormer under int8, D = 64; the SD1.5
//     UNet and ControlNet with `int8_attention`, D = 40 and 80), after K9's
//     prologue `k_head_quant_kernel` (int8_attention.cu), unchanged.
// Its parents, `fa_narrow_kernel` (flash_attention.cu) and
// `int8_attn_kernel` (int8_attention.cu), issue Ampere's mma.sync from
// ldmatrix fragments. They stay as the parent designs that
// tools/attn_tune.py and the lab time beside this one (their explicit
// launches, ops/flash_attention.py's `_parent_launch` and
// `_int8_parent_launch`), and `fa_narrow_kernel` for K1's head dimensions
// this kernel does not instantiate. No lab mode runs them any more.
//
// Numerics, as the parents': logits, running max and running sum in fp32;
// the row maximum over the unscaled logits (bf16) or the exact integer
// sums (int8), scaled once (scale > 0, checked); each probability one FFMA
// into ex2: p = 2^(s * c - m) with c = scale * log2(e) (bf16) or
// sq_r * (skh * scale) * log2(e) (int8); P rounded to bf16 against the
// running maximum; the sum over the fp32 P; O rescaled only when a row
// maximum of the warp moved; one division at the end. Only the key tile
// (128, or 112 for K9; the parents' 64) moves where P's bf16 rounding
// falls. K9's Q
// codes are the parent's bit for bit: per row max(amax / 127, 1e-8) by IEEE
// division, rint(q / sq) clipped to +-127.
//
// What bounds it on the H100 (`tools/timing.py::roofline`): on paper the
// exponentials, one per logit (~3.9e12/s), ahead of the two products (989
// TFLOP/s bf16, 1979 TOP/s int8) at D <= 80; both close at D = 128. The
// parents measured at about half of SDPA's speed, bound (their ablation,
// tools/attn_tune.py --part ablate) by the mma.sync products and their
// ldmatrix operand loads. This kernel moves the products onto `wgmma`, after
// FlashAttention-3 (Shah et al. 2024):
//   * a block owns 64 query rows per consumer warpgroup of one (batch,
//     head): three consumers at D <= 64 (192 rows), two otherwise (128
//     rows), and one producer warpgroup. `setmaxnreg` gives the producer
//     40 (32 with three consumers) registers a thread and each consumer 232
//     (160). More rows in flight hide the softmax's latency, which binds two
//     consumers (no single unit does: taking out the exponentials, the P.V
//     products or the copies each saves a part only). K9's three consumers
//     run 112-key tiles: at 128 keys their 160 registers spill;
//   * one producer thread issues TMA copies (`cp.async.bulk.tensor`) of
//     Q once and of the K and V tiles of 128 keys into rings of two
//     stages, separate barriers for K and V (`mbarrier` with a byte count
//     per stage; the consumers release K after Q.K^T and V after P.V);
//   * every shared tile row is one 128-byte swizzle span (SWIZZLE_128B),
//     64 bf16 values or 128 int8 codes; a wider row is split into
//     column blocks of that span. The tensor maps are 4-D over (D, N, H,
//     B) with the caller's strides, so a box never crosses into the next
//     sample (ragged N), column slices of one qkv projection map as they
//     are, and the columns past D inside the 128-byte box (D = 40: 40..63;
//     D = 80: 80..127 of the second block; int8 D = 64: 64..127) lie
//     outside dimension 0 and arrive as zeros from TMA: a pad never holds
//     another head's values. Rows past N arrive as zeros too: the key tail
//     is masked to -inf on the last tile (a zero key row has logit 0), the
//     query tail is computed and not stored;
//   * S = Q.K^T is `wgmma` m64n128k16 bf16 -> fp32 with Q and K from
//     shared memory (K-major, D padded to a multiple of 16: 40 -> 48 over
//     zeros), or, in K9, m64n128k32 s8 -> s32 with Q's codes in registers:
//     each consumer quantizes its 64 rows from the swizzled Q tile straight
//     into the register-A fragments (per warp m16n8k32's A layout), D
//     padded to a multiple of 32 (40 -> 64, 80 -> 96). The Q codes past D
//     are 0: they come from TMA's zero fill of the bf16 tile, so whatever
//     K's tile holds there adds nothing to the exact integer sums;
//   * K9's K codes at D = 40: a dense (B, N, H, D) layout of them has a
//     40-byte head stride, which a tensor map cannot take (strides are
//     multiples of 16 bytes), and a map over the packed rows whose box
//     starts at column h*D (not 16-byte aligned) faults on the card
//     (`cudaErrorIllegalInstruction`). So K9p writes the codes with their
//     heads 48 bytes apart, (B, N, H, 48) memory whose last 8 bytes a head
//     stay unwritten: the map's extent stays D, and TMA fills the box's
//     columns past D with zeros (`ops/flash_attention.py::Sm90Plan.
//     k_head_bytes`). At D = 32, 64, 80 and 128 the codes stay dense;
//   * P.V is `wgmma` m64nDk16 bf16 with P in registers (the fp32
//     accumulator of two adjacent 8-key tiles is the A fragment of one
//     k16 step) and V read from shared memory as the MN-major (transposed)
//     B operand, N = D (40, 64, 80 or 128: a multiple of 8);
//   * a consumer issues tile j's Q.K^T and then tile j - 1's P.V as one
//     turn, and waits for Q.K^T alone (`wgmma.wait_group 1`) before tile
//     j's softmax. ptxas moves the wait for the P.V up to that point
//     (SASS: WARPGROUP.DEPBAR.LE gsb0, 0x0 ahead of the MUFU.EX2s), so a
//     softmax overlaps the other consumers' products, not its own P.V;
//     the consumers take turns issuing their products through named
//     barriers (ping-pong, round robin over three);
//   * the loop body is straight-line from a turn's issue to the waits: the
//     masked last tile (ragged N) is a separate instantiation of the step.
// The grid is (ceil(Nq / rows), B * H), one block per SM. Designs timed
// against this one and not kept (`tools/attn_tune.py --part sm90` as it
// stood when they were built; device ms at K1's SD1.5 64² shape
// (8,4096,320) H=8 and K9's SD3 joint shape, NVIDIA H100 80GB HBM3, 700 W):
// 64-key tiles (K1 0.662 against 0.537); two consumers at D <= 64 (0.622);
// the P.V's wait forced into the arms of the rescale branch, so that a
// softmax overlaps its own P.V (0.533; K9 0.553 against 0.540: within the
// spread); K9 on three consumers at 96-key tiles (0.566 against 0.540).
//
// The lab modes (attention_sm90_lab.cu, attention_sm90_lab_two_pass.cu;
// `attn_sm90_lab_kernel`, L4 `attn_sm90_rowk_kernel`) are instantiations of
// the same block with the mode and the key tile as template parameters:
// two or three consumers (three at D <= 64), 64- or 128-key tiles
// (`lab_ok`; L4 on K9's plans). kOnline, the lab's online softmax at a
// chosen tile (tools/attn_variants.py::_online_kernel), is K1's loop.
// kNoSoftmax (L2, the same lab kernel with do_softmax=False) is its turn
// without the softmax: O = sum_j bf16(s_ij * scale) V_j, each tile's
// Q.K^T, one FMUL by the scale and the round to bf16 into P.V's A
// fragments, P.V into fp32 O, O stored as it is: no maximum, exponential,
// sum, warp vote or division, and no key-tail mask (K's and V's rows past
// N arrive as zeros, so s = 0 and P = 0 there). P is elementwise, so only
// the order of the fp32 sums of s and of O moves, not where P's rounding
// falls. kRowK (L4, tools/attn_int8_lab.py::_kernel_v2) is K9 with one K
// scale per (batch, key row, head), from the prologue
// `k_row_codes_kernel`: the scale enters each logit before the row
// maximum, x = f32(s32) * sk_j (one FMUL), the maximum over x, then p =
// 2^(x * c - m) with c = sq * scale * log2(e), one FFMA as in K9 (the
// plain version and the parent round (f32(s32) * (sq * sk_j)) * scale:
// another order of the same three factors). A tile's key scales arrive by
// TMA (a 2-D map over the (B * H) rows of scales, their pitch rounded up
// to 4 floats by the prologue: the map's strides are whole 16 bytes; the
// keys past N arrive as zeros and are masked) into a ring of their own
// beside K's, read with LDS in the softmax and released once read: K9's
// three consumers hold no spare registers for them. kTwoPass
// stands for the full-K kernels of attn_variants.py, attn_lab2.py and
// attn_lab3.py, which hold a whole logits row and take one softmax: as the
// parent's two-pass mode, it makes two passes over the keys.
//   * the producer streams every K tile once (pass 1), then K and V (pass
//     2); the K ring's stage and phase run on across both passes (tile j
//     of pass 2 is ring tile nkt + j), and the V ring idles in pass 1;
//   * pass 1: Q.K^T in the consumers' turns, the key tail masked on the
//     last tile, the row maximum of the unscaled logits (scaled once, as
//     in K1), each K stage released after its wait;
//   * pass 2: K1's step with m fixed: p = 2^(s * c - m), one FFMA into
//     ex2, l the sum of the fp32 P, P rounded to bf16 against the exact row
//     maximum, P.V in fp32, one division at the end: no correction of l or
//     O and no warp vote. The numbers are the parent two-pass mode's
//     (flash_attention.cu): only the order of the fp32 sums moves.
// It computes Q.K^T twice, 1.5x K1's products: at (8,4096,8,64) 0.417 ms
// of bf16 operations against the function's bound of 0.278. Measured
// (`tools/attn_tune.py --part lab`, device ms at B = 8, N = 4096, H = 8;
// NVIDIA H100 80GB HBM3, 700 W): L1 on K1's tile 0.533 (K1's own 0.52-0.54);
// L3 on K1's tile 0.649-0.656 at D = 40, 0.691-0.697 at 64, 1.092 at 128
// (SDPA 0.580, 0.601, 0.860; the parent's best tile 1.37-4.6). Pass 1 costs
// about its products: L3 less K1 at D = 40 is 0.12 ms, against 0.104 ms of
// padded Q.K^T at the tensor cores' peak. No one unit bounds L3: without
// the exponentials it saves 4-7%, without the P.V products 1-6%, without
// the K/V copies after the first stages 3-8%; without the ping-pong D = 64
// runs 10% slower. 64-key tiles and two consumers lose at every shape (L3
// at D = 40: 0.869-1.046). L2 on K1's tile 0.408 (64-key tiles 0.518; the
// parent's best tile 0.857): its copies bind it, without the K/V copies
// after the first stages 0.296, without the P.V products 0.401, without
// the ping-pong 0.410. L4 at (2,4250,24,64) on three consumers 0.563-0.578
// (two 0.697-0.722; the parent 0.908-0.920): no one unit, without the
// exponentials -6%, without the P.V products -10%, without the copies 0%.
// One build-time switch, PD_SM90_ABLATE, is for tools/attn_tune.py's
// ablated copies: it takes a part out (1 the exponentials, 2 the P.V
// products, 4 the K/V copies after the first stages, 8 the ping-pong); an
// ablated copy's output is wrong by design.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef PD_SM90_ABLATE
#define PD_SM90_ABLATE 0
#endif

namespace pd_sm90 {

constexpr int NS = 2;          // stages of the K and V rings
constexpr int SPAN = 128;      // bytes of a shared tile row: one 128-byte swizzle span
constexpr int SMEM_MAX = 232448;
constexpr int MAX_DEVICES = 64;  // devices whose shared-memory limit `launch` remembers
// consumer warpgroups of 64 query rows: three at D <= 64, else two; K9 at
// D <= 64 also takes two where the plan says so (ops/flash_attention.py::
// sm90_consumers)
__host__ __device__ constexpr int consumers(int d) { return d <= 64 ? 3 : 2; }
__host__ __device__ constexpr bool consumers_ok(int d, bool int8, int nc) {
  return nc == consumers(d) || (int8 && d <= 64 && (nc == 2 || nc == 3));
}
// keys of a tile: 128, and 112 for K9 on three consumers (whose 160
// registers a thread hold 128-key tiles only with spills)
__host__ __device__ constexpr int block_k(bool int8, int nc) {
  return int8 && nc == 3 ? 112 : 128;
}
// registers a thread: the producer's and the consumers', within the SM's
// 65536 (40 * 128 + 232 * 256, 32 * 128 + 160 * 384)
__host__ __device__ constexpr int producer_regs(int nc) { return nc == 2 ? 40 : 32; }
__host__ __device__ constexpr int consumer_regs(int nc) { return nc == 2 ? 232 : 160; }
// the modes, numbered as flash_attention.cu's: K1's online softmax, the
// lab's no-softmax sum and its two passes over the keys; then the lab's
// int8 mode with one K scale per key row (K9's online softmax)
constexpr int kOnline = 0, kNoSoftmax = 1, kTwoPass = 2, kRowK = 3;
// the lab modes' instantiations (attention_sm90_lab.cu,
// attention_sm90_lab_two_pass.cu): kOnline and kNoSoftmax at D = 40 (L1,
// L2), kTwoPass at D = 40, 64 and 128 (L3 and its heads padded to 64 and
// 128), on two or three consumers (three at D <= 64) and 64- or 128-key
// tiles; kRowK at D = 64 (L4) on K9's plans: three consumers at 112-key
// tiles or two at 128
__host__ __device__ constexpr bool lab_ok(int d, int mode, int nc, int bk) {
  return mode == kRowK
             ? d == 64 && (nc == 2 || nc == 3) && bk == block_k(true, nc)
             : (mode == kOnline || mode == kNoSoftmax
                    ? d == 40
                    : mode == kTwoPass && (d == 40 || d == 64 || d == 128)) &&
                   (nc == 2 || (nc == 3 && d <= 64)) && (bk == 64 || bk == 128);
}
// 128-byte column blocks of a bf16 Q or V row, of a K row
__host__ __device__ constexpr int qv_blocks(int d) { return (2 * d + SPAN - 1) / SPAN; }
__host__ __device__ constexpr int k_blocks(int d, bool int8) {
  return int8 ? (d + SPAN - 1) / SPAN : qv_blocks(d);
}
// bytes of a stage of kRowK's key scales: a tile's bk fp32 scales, 128-byte
// aligned (TMA's destination)
__host__ __device__ constexpr int scale_stage(int bk) { return (4 * bk + SPAN - 1) / SPAN * SPAN; }
// dynamic shared memory of a block: Q, the K and V stages of bk-key tiles,
// the key scales' stages (kRowK), the alignment slack
__host__ __device__ constexpr int smem_bytes(int d, bool int8, int nc, int bk,
                                             bool row_k = false) {
  return (qv_blocks(d) * 64 * nc + NS * (k_blocks(d, int8) + qv_blocks(d)) * bk) * SPAN +
         (row_k ? NS * scale_stage(bk) : 0) + 1024;
}
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ABLATE = PD_SM90_ABLATE;
constexpr int ABL_NO_EXP = 1, ABL_NO_PV = 2, ABL_NO_COPY = 4, ABL_NO_PINGPONG = 8;

// Shared memory of a block: Q (QB column blocks of BQ rows), then NS K
// stages (KB blocks of BK rows), then NS V stages (QB blocks of BK rows),
// every block 1024-byte aligned, then with ROWK NS stages of the key
// scales; the mbarriers are static.
template <int D, bool INT8, int NC_, int BK_ = block_k(INT8, NC_), bool ROWK = false>
struct Plan {
  static constexpr int NC = NC_;
  static constexpr int BK = BK_;                   // keys of a tile
  static constexpr int BQ = 64 * NC;               // query rows of a block
  static constexpr int NTHREADS = 128 * (1 + NC);  // the producer warpgroup, then the consumers
  static constexpr int QB = qv_blocks(D);
  static constexpr int KB = k_blocks(D, INT8);
  static constexpr int Q_BYTES = QB * BQ * SPAN;
  static constexpr int K_STAGE = KB * BK * SPAN;
  static constexpr int V_STAGE = QB * BK * SPAN;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + NS * K_STAGE;
  static constexpr int S_STAGE = ROWK ? scale_stage(BK) : 0;  // key scales (kRowK)
  static constexpr int OFF_S = OFF_V + NS * V_STAGE;
  static constexpr int SMEM = smem_bytes(D, INT8, NC, BK, ROWK);
  static constexpr int KSTEPS = INT8 ? (D + 31) / 32 : (D + 15) / 16;  // k-steps of Q.K^T
  static_assert(SMEM == OFF_S + NS * S_STAGE + 1024 && SMEM <= SMEM_MAX, "shared memory");
  static_assert(!ROWK || INT8, "key scales of int8 codes");
  // three consumers' O accumulators fit their registers only at D <= 64
  static_assert(NC == 2 || (NC == 3 && D <= 64), "consumers");
  static_assert(BK == 64 || BK == 112 || BK == 128, "key tile");
  static_assert(D % 8 == 0 && D <= 128, "head dimension");
  // the depth of Q.K^T within a Q tile row (bf16) and a K tile row
  static_assert(KSTEPS * (INT8 ? 32 : 16) <= QB * 64 &&
                    KSTEPS * (INT8 ? 32 : 16) <= KB * SPAN / (INT8 ? 1 : 2),
                "depth of Q.K^T");
};

struct Params {
  __nv_bfloat16* o;
  int64_t o_sb, o_sn, o_sh;  // element strides of the output's batch, row and head
  const float* sk;           // K9: (B, H) K scales
  int heads, nq, nk;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// box (c0.., c1..) of a 4-D tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// box (c0.., c1) of a 2-D tensor map (kRowK's key scales) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- warpgroups --------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// named barriers among the consumers (THREADS: all of them; one syncs,
// the others arrive)
template <int THREADS>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}
template <int THREADS>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma reads or writes across the issue or the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
  }
}

// Shared-memory matrix descriptors of 128-byte swizzled tiles (rows of 128
// bytes, 8-row groups 1024 bytes apart): K-major (Q, K; a k-step starts
// 32 bytes further along the row, or in the next column block), and
// MN-major (V as P.V's B: 16-key k-steps 2048 bytes apart, D's 64-value
// column blocks `lbo` bytes apart).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// ---- wgmma: one warpgroup's 64-row products (PTX operand lists written out) ----

// d (64 x 128) = or += A (64 x 16, shared) * B (128 x 16, shared, K-major)^T, bf16 into fp32
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
               : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64) = or += A (64 x 16, shared) * B (64 x 16, shared, K-major)^T, bf16 into fp32
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                   "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
               : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 32) += A (64 x 16, registers) * B (16 x 32, shared, MN-major), bf16 into fp32
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 40) += A (64 x 16, registers) * B (16 x 40, shared, MN-major), bf16 into fp32
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[20], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major), bf16 into fp32
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                   "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80) += A (64 x 16, registers) * B (16 x 80, shared, MN-major), bf16 into fp32
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                   "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                   "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                   "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                   "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                   "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                   "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, MN-major), bf16 into fp32
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) = or += A (64 x 32, registers) * B (128 x 32, shared, K-major)^T, s8 into s32
__device__ __forceinline__ void wgmma_rs_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
                   "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
                   "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                   "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
                   "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
                   "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
                   "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
                   "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
                   "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
                   "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
                   "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
                   "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
                   "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
                   "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
                   "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
                   "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 112) = or += A (64 x 32, registers) * B (112 x 32, shared, K-major)^T, s8 into s32
__device__ __forceinline__ void wgmma_rs_s8(int (&d)[56], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, {%56, %57, %58, %59}, %60, p;\n}\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
                   "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
                   "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                   "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
                   "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
                   "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
                   "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
                   "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
                   "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
                   "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
                   "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
                   "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
                   "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
                   "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// ---- softmax helpers ---------------------------------------------------------

// two fp32 -> one bf16x2 register, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  if (ABLATE & ABL_NO_EXP) return x;
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// f32(s) for |s| < 2^22, exactly (the bits of 1.5 * 2^23 plus s are the
// float 1.5 * 2^23 + s)
__device__ __forceinline__ float s32_to_f32(int s) {
  return __int_as_float(s + 0x4B400000) - 12582912.f;
}

// the int8 code of x at scale s: clip(rint(x / s), -127, 127), IEEE division
__device__ __forceinline__ uint32_t code8(float x, float s) {
  const float c = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(c)) & 0xffu;
}

// the logit registers as floats: K9's int32 accumulators hold float bits
// once its softmax has converted them in place
__device__ __forceinline__ float as_f(float v) { return v; }
__device__ __forceinline__ float as_f(int v) { return __int_as_float(v); }
__device__ __forceinline__ void put_f(float& d, float v) { d = v; }
__device__ __forceinline__ void put_f(int& d, float v) { d = __float_as_int(v); }

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <bool INT8>
struct Acc {
  using type = float;
};
template <>
struct Acc<true> {
  using type = int;
};

// The 1024-byte aligned start of dynamic shared memory (the swizzle atoms
// of the tiles; the launch adds the slack).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* smem) {
  return smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
}

// ---- the kernel ------------------------------------------------------------------

// MODE: kOnline (K1, K2, K9, L1), kNoSoftmax (L2) or kTwoPass (L3), both
// bf16 only, or kRowK (L4, int8 only; `tsk` its key scales); BK_: the key
// tile
template <int D, bool INT8, int NC_, int BK_ = block_k(INT8, NC_), int MODE = kOnline>
__device__ __forceinline__ void attn_sm90(const CUtensorMap* tq, const CUtensorMap* tk,
                                          const CUtensorMap* tv, const Params& p,
                                          const CUtensorMap* tsk = nullptr) {
  static_assert(MODE == kOnline || ((MODE == kNoSoftmax || MODE == kTwoPass) && !INT8) ||
                    (MODE == kRowK && INT8),
                "mode");
  using L = Plan<D, INT8, NC_, BK_, MODE == kRowK>;
  using A = typename Acc<INT8>::type;
  constexpr int NC = L::NC, BQ = L::BQ, CT = 128 * NC;  // consumers, query rows, consumer threads
  constexpr int BK = L::BK;
  constexpr int NS8 = BK / 8;    // 8-key column tiles of S
  constexpr int NO = D / 8;      // 8-column tiles of O
  constexpr int NP = BK / 16;    // k16 steps of P.V
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + (MODE == kRowK ? 6 : 4) * NS];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t q_full = bar0;
  auto full_k = [&](int s) { return bar0 + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar0 + 8 * (1 + NS + s); };
  auto empty_k = [&](int s) { return bar0 + 8 * (1 + 2 * NS + s); };
  auto empty_v = [&](int s) { return bar0 + 8 * (1 + 3 * NS + s); };
  auto full_s = [&](int s) { return bar0 + 8 * (1 + 4 * NS + s); };   // kRowK's key scales
  auto empty_s = [&](int s) { return bar0 + 8 * (1 + 5 * NS + s); };
  auto k_tile = [&](int s) { return s_base + L::OFF_K + s * L::K_STAGE; };
  auto v_tile = [&](int s) { return s_base + L::OFF_V + s * L::V_STAGE; };

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int nkt = (p.nk + BK - 1) / BK;
  // K ring tiles ahead of the key loop: kTwoPass's pass 1 streams every K
  // tile once, so key tile j of the loop is ring tile k0 + j
  const int k0 = MODE == kTwoPass ? nkt : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), CT);
      mbar_init(empty_v(s), CT);
    }
    if constexpr (MODE == kRowK) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        mbar_init(full_s(s), 1);
        mbar_init(empty_s(s), CT);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- the producer: one thread issues every copy
    setmaxnreg_dec<producer_regs(NC)>();
    if (threadIdx.x == 0) {
      constexpr int KE = INT8 ? SPAN : SPAN / 2;  // values of a K block row
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int qb = 0; qb < L::QB; ++qb) tma_load(s_base + qb * BQ * SPAN, tq, q_full, qb * 64, q0, h, b);
      if constexpr (MODE == kTwoPass) {  // pass 1: K alone, ring tiles 0 .. nkt - 1
        for (int j = 0; j < nkt; ++j) {
          const int s = j % NS;
          mbar_wait(empty_k(s), ((j / NS) & 1) ^ 1);  // the first round finds the stages free
          if (!(ABLATE & ABL_NO_COPY) || j < NS) {
            mbar_expect_tx(full_k(s), L::K_STAGE);
#pragma unroll
            for (int kb = 0; kb < L::KB; ++kb) {
              tma_load(k_tile(s) + kb * BK * SPAN, tk, full_k(s), kb * KE, j * BK, h, b);
            }
          } else {
            mbar_arrive(full_k(s));
          }
        }
      }
      for (int j = 0; j < nkt; ++j) {
        const int s = j % NS, sk = (k0 + j) % NS;  // the V and K ring stages of key tile j
        const uint32_t ph = ((j / NS) & 1) ^ 1;  // the first round finds the stages free
        const uint32_t phk = (((k0 + j) / NS) & 1) ^ 1;
        const bool copy = !(ABLATE & ABL_NO_COPY) || j < NS;
        mbar_wait(empty_k(sk), phk);
        if (copy) {
          mbar_expect_tx(full_k(sk), L::K_STAGE);
#pragma unroll
          for (int kb = 0; kb < L::KB; ++kb) {
            tma_load(k_tile(sk) + kb * BK * SPAN, tk, full_k(sk), kb * KE, j * BK, h, b);
          }
        } else {
          mbar_arrive(full_k(sk));
        }
        if constexpr (MODE == kRowK) {  // the tile's key scales: row b * H + h of the map
          mbar_wait(empty_s(s), ph);
          mbar_expect_tx(full_s(s), 4 * BK);
          tma_load_2d(s_base + L::OFF_S + s * L::S_STAGE, tsk, full_s(s), j * BK, blockIdx.y);
        }
        mbar_wait(empty_v(s), ph);
        if (copy) {
          mbar_expect_tx(full_v(s), L::V_STAGE);
#pragma unroll
          for (int vb = 0; vb < L::QB; ++vb) {
            tma_load(v_tile(s) + vb * BK * SPAN, tv, full_v(s), vb * 64, j * BK, h, b);
          }
        } else {
          mbar_arrive(full_v(s));
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup c owns query rows 64 c .. 64 c + 63
  setmaxnreg_inc<consumer_regs(NC)>();
  const int tid = threadIdx.x - 128;
  const int c = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  // Turns: consumer c issues its products after every other consumer has
  // issued since its last turn (barrier 1 + c), then hands the turn on;
  // consumers 1.. start having handed it to those before them.
  const bool pingpong = !(ABLATE & ABL_NO_PINGPONG);
  if (pingpong) {
    for (int other = 0; other < c; ++other) named_arrive<CT>(1 + other);
  }
  auto my_turn = [&]() {
    if (pingpong) named_sync<CT>(1 + c);
  };
  auto their_turn = [&]() {
    if (pingpong) {
#pragma unroll
      for (int i = 1; i < NC; ++i) named_arrive<CT>(1 + (c + i) % NC);
    }
  };
  const uint32_t q_rows = s_base + c * 64 * SPAN;  // this warpgroup's rows in each Q block

  // K9: Q's s8 A fragments (rows g, g + 8 of the warp; bytes 4t.. and
  // 16 + 4t.. of each k32 step) and per row c_r = sq * (skh * scale) * log2(e)
  // (kRowK: sq * scale * log2(e); the key scale is in the logit)
  uint32_t qa[INT8 ? L::KSTEPS : 1][4];
  float kf[2];
  mbar_wait(q_full, 0);
  if constexpr (INT8) {
    const float hs =
        MODE == kRowK ? p.scale : __fmul_rn(p.sk[b * p.heads + h], p.scale);  // skh * scale
    const int rows[2] = {c * 64 + warp * 16 + g, c * 64 + warp * 16 + g + 8};
    // 4 bf16 of row r from column col (col % 4 == 0) of the swizzled Q tile
    auto load4 = [&](float (&x)[4], int r, int col) {
      const int e = col & 63;
      const uint2 u = *reinterpret_cast<const uint2*>(
          smem + (col >> 6) * BQ * SPAN + r * SPAN + (((e >> 3) ^ (r & 7)) << 4) + (e & 7) * 2);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
    };
    float amax[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < L::KSTEPS; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x[4];
          load4(x, rows[r], kk * 32 + half * 16 + 4 * t);
          amax[r] = fmaxf(amax[r], fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])),
                                         fmaxf(fabsf(x[2]), fabsf(x[3]))));
        }
      }
    }
    float sq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sq[r] = fmaxf(__fdiv_rn(quad_max(amax[r]), 127.f), 1e-8f);
      kf[r] = __fmul_rn(__fmul_rn(sq[r], hs), LOG2E);
    }
#pragma unroll
    for (int kk = 0; kk < L::KSTEPS; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x[4];
          load4(x, rows[r], kk * 32 + half * 16 + 4 * t);
          qa[kk][2 * half + r] = code8(x[0], sq[r]) | (code8(x[1], sq[r]) << 8) |
                                 (code8(x[2], sq[r]) << 16) | (code8(x[3], sq[r]) << 24);
        }
      }
    }
  } else {
    kf[0] = kf[1] = p.scale * LOG2E;
  }

  A s[BK / 2];            // S of the tile in flight: row g + 8 (i / 2 % 2), key 8 (i / 4) + 2t + i % 2
  uint32_t pa[NP][4];     // bf16 P of the previous tile, P.V's A fragments
  float o[D / 2];         // O: row g + 8 (i / 2 % 2), column 8 (i / 4) + 2t + i % 2
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  auto issue_qk = [&](int stage) {
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < L::KSTEPS; ++ks) {
      const uint32_t koff = (ks >> 2) * BK * SPAN + (ks & 3) * 32;
      if constexpr (INT8) {
        wgmma_rs_s8(s, qa[ks], desc_sw128(k_tile(stage) + koff, 16), ks > 0);
      } else {
        wgmma_ss_bf16(s, desc_sw128(q_rows + (ks >> 2) * BQ * SPAN + (ks & 3) * 32, 16),
                      desc_sw128(k_tile(stage) + koff, 16), ks > 0);
      }
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int stage) {
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    if (!(ABLATE & ABL_NO_PV)) {
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        wgmma_rs_bf16(o, pa[kk], desc_sw128(v_tile(stage) + kk * 16 * SPAN, BK * SPAN));
      }
    }
    wgmma_commit();
  };
  // the key tail of tile j's logits to -inf where `masked` (the last tile).
  // Straight-line code: ptxas keeps a wgmma group in flight only across
  // code without branches, so the tail is masked by selects in a separate
  // instantiation.
  auto mask_tail = [&](int j, auto masked) {
    if constexpr (decltype(masked)::value) {
#pragma unroll
      for (int n = 0; n < NS8; ++n) {
        const int col = j * BK + n * 8 + 2 * t;
        const bool out0 = col >= p.nk, out1 = col + 1 >= p.nk;
        put_f(s[4 * n], out0 ? -INFINITY : as_f(s[4 * n]));
        put_f(s[4 * n + 2], out0 ? -INFINITY : as_f(s[4 * n + 2]));
        put_f(s[4 * n + 1], out1 ? -INFINITY : as_f(s[4 * n + 1]));
        put_f(s[4 * n + 3], out1 ? -INFINITY : as_f(s[4 * n + 3]));
      }
    }
  };
  // the row maxima of rows g and g + 8 over m and the tile's logits, in
  // log2 units (scaled once: c > 0), in four partial chains each (a
  // maximum is exact in any order): a short dependency chain ahead of the
  // exponentials
  auto new_max = [&](float (&mx)[2]) {
    float r0[4], r1[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      r0[n] = fmaxf(as_f(s[4 * n]), as_f(s[4 * n + 1]));
      r1[n] = fmaxf(as_f(s[4 * n + 2]), as_f(s[4 * n + 3]));
    }
#pragma unroll
    for (int n = 4; n < NS8; ++n) {
      r0[n % 4] = fmaxf(r0[n % 4], fmaxf(as_f(s[4 * n]), as_f(s[4 * n + 1])));
      r1[n % 4] = fmaxf(r1[n % 4], fmaxf(as_f(s[4 * n + 2]), as_f(s[4 * n + 3])));
    }
    mx[0] = fmaxf(m[0], quad_max(fmaxf(fmaxf(r0[0], r0[1]), fmaxf(r0[2], r0[3]))) * kf[0]);
    mx[1] = fmaxf(m[1], quad_max(fmaxf(fmaxf(r1[0], r1[1]), fmaxf(r1[2], r1[3]))) * kf[1]);
  };
  // tile j's logits in s to probabilities (fp32, in place) and the row
  // sums; kOnline and kRowK also the new row maxima and corr, the factor of
  // the rows' earlier O (kTwoPass: m is the exact row maximum, from pass 1).
  // kNoSoftmax: the logits times the scale alone, no maximum, exponential
  // or sum; the key tail needs no mask there, since rows past N arrive as
  // zeros for K (s = 0, so P = 0) and for V.
  auto softmax = [&](int j, float (&corr)[2], auto masked) {
    if constexpr (MODE == kNoSoftmax) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = __fmul_rn(s[i], p.scale);
      return;
    }
    if constexpr (MODE == kRowK) {
      // x = f32(s32) * sk_j: each key's scale before the row maximum, from
      // the tile's stage of scales (LDS; released once read)
      const int st = j % NS;
      mbar_wait(full_s(st), (j / NS) & 1);
      const float* sks = reinterpret_cast<const float*>(smem + L::OFF_S + st * L::S_STAGE);
#pragma unroll
      for (int n = 0; n < NS8; ++n) {
        const float2 skj = *reinterpret_cast<const float2*>(sks + n * 8 + 2 * t);
        put_f(s[4 * n], __fmul_rn(s32_to_f32(s[4 * n]), skj.x));
        put_f(s[4 * n + 1], __fmul_rn(s32_to_f32(s[4 * n + 1]), skj.y));
        put_f(s[4 * n + 2], __fmul_rn(s32_to_f32(s[4 * n + 2]), skj.x));
        put_f(s[4 * n + 3], __fmul_rn(s32_to_f32(s[4 * n + 3]), skj.y));
      }
      mbar_arrive(empty_s(st));
    } else if constexpr (INT8) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) put_f(s[i], s32_to_f32(s[i]));
    }
    mask_tail(j, masked);
    if constexpr (MODE == kOnline || MODE == kRowK) {
      float mx[2];
      new_max(mx);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        corr[r] = ex2(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
        m[r] = mx[r];
        l[r] *= corr[r];
      }
    }
#pragma unroll
    for (int n = 0; n < NS8; ++n) {  // p = 2^(s * c - m), one FFMA
      const float p0 = ex2(fmaf(as_f(s[4 * n]), kf[0], -m[0]));
      const float p1 = ex2(fmaf(as_f(s[4 * n + 1]), kf[0], -m[0]));
      const float p2 = ex2(fmaf(as_f(s[4 * n + 2]), kf[1], -m[1]));
      const float p3 = ex2(fmaf(as_f(s[4 * n + 3]), kf[1], -m[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      put_f(s[4 * n], p0);
      put_f(s[4 * n + 1], p1);
      put_f(s[4 * n + 2], p2);
      put_f(s[4 * n + 3], p3);
    }
  };
  // P to bf16 A fragments: 8-key tiles 2kk and 2kk + 1 are k16 step kk
  auto to_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) {
      pa[kk][0] = pack_bf16(as_f(s[8 * kk]), as_f(s[8 * kk + 1]));
      pa[kk][1] = pack_bf16(as_f(s[8 * kk + 2]), as_f(s[8 * kk + 3]));
      pa[kk][2] = pack_bf16(as_f(s[8 * kk + 4]), as_f(s[8 * kk + 5]));
      pa[kk][3] = pack_bf16(as_f(s[8 * kk + 6]), as_f(s[8 * kk + 7]));
    }
  };
  // the last tile holds the key tail (kNoSoftmax masks none)
  const bool ragged = MODE != kNoSoftmax && p.nk % BK != 0;
  if constexpr (MODE == kTwoPass) {
    // pass 1: the exact row maxima, each tile's Q.K^T in this consumer's
    // turn, its K stage released after the wait
    auto max_step = [&](int j, auto masked) {
      const int st = j % NS;
      mbar_wait(full_k(st), (j / NS) & 1);
      my_turn();
      issue_qk(st);
      their_turn();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(empty_k(st));
      mask_tail(j, masked);
      float mx[2];
      new_max(mx);
      m[0] = mx[0];
      m[1] = mx[1];
    };
    for (int j = 0; j < nkt - 1; ++j) max_step(j, Flag<false>());
    if (ragged) {
      max_step(nkt - 1, Flag<true>());
    } else {
      max_step(nkt - 1, Flag<false>());
    }
  }
  // tile 0: S only
  float corr[2];
  mbar_wait(full_k(k0 % NS), (k0 / NS) & 1);
  my_turn();
  issue_qk(k0 % NS);
  their_turn();
  wgmma_wait<0>();
  fence_regs(s);
  mbar_arrive(empty_k(k0 % NS));
  if (ragged && nkt == 1) {
    softmax(0, corr, Flag<true>());
  } else {
    softmax(0, corr, Flag<false>());
  }
  to_p();
  // tile j: S_j, then P_{j-1} V_{j-1} behind it; the softmax of S_j while
  // that product runs
  auto step = [&](int j, auto masked) {
    const int st = (k0 + j) % NS, prev = (j - 1) % NS;
    mbar_wait(full_k(st), ((k0 + j) / NS) & 1);
    my_turn();
    issue_qk(st);
    mbar_wait(full_v(prev), ((j - 1) / NS) & 1);
    issue_pv(prev);
    their_turn();
    wgmma_wait<1>();
    fence_regs(s);
    mbar_arrive(empty_k(st));
    softmax(j, corr, masked);
    wgmma_wait<0>();  // the P.V in flight, then O *= corr where a row maximum of the warp moved
    fence_regs(o);
    fence_regs(pa);
    if constexpr (MODE == kOnline || MODE == kRowK) {
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[4 * n] *= corr[0];
          o[4 * n + 1] *= corr[0];
          o[4 * n + 2] *= corr[1];
          o[4 * n + 3] *= corr[1];
        }
      }
    }
    mbar_arrive(empty_v(prev));
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
    my_turn();
    issue_pv(last);
    their_turn();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(empty_v(last));
  }
  // consumer 0 takes the last hand-offs of the others (the later consumers'
  // start-up hand-offs to each other stay behind at the block's end)
  if (pingpong && c == 0) named_sync<CT>(1);

  // O / l (kNoSoftmax: O), stored as bf16 pairs straight from the
  // accumulators
  if constexpr (MODE == kNoSoftmax) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + c * 64 + warp * 16 + g + 8 * r;
      if (qi >= p.nq) continue;
      __nv_bfloat16* orow = p.o + b * p.o_sb + static_cast<int64_t>(qi) * p.o_sn + h * p.o_sh;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
      }
    }
    return;
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + c * 64 + warp * 16 + g + 8 * r;
    if (qi >= p.nq) continue;
    __nv_bfloat16* orow = p.o + b * p.o_sb + static_cast<int64_t>(qi) * p.o_sn + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] / l[r], o[4 * n + 2 * r + 1] / l[r]);
    }
  }
}

// K1 and K2 (bf16 Q, K, V)
template <int D>
__global__ void __launch_bounds__(Plan<D, false, consumers(D)>::NTHREADS, 1)
    attn_sm90_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  attn_sm90<D, false, consumers(D)>(&tq, &tk, &tv, p);
}

// K9 (bf16 Q and V, K9p's int8 K codes), on NC consumers
template <int D, int NC>
__global__ void __launch_bounds__(Plan<D, true, NC>::NTHREADS, 1)
    attn_sm90_int8_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Params p) {
  attn_sm90<D, true, NC>(&tq, &tk, &tv, p);
}

// The lab modes L1 (kOnline), L2 (kNoSoftmax) and L3 (kTwoPass) on bf16 Q,
// K, V, at BK-key tiles on NC consumers (attention_sm90_lab.cu,
// attention_sm90_lab_two_pass.cu)
template <int D, int NC, int BK, int MODE>
__global__ void __launch_bounds__(Plan<D, false, NC, BK>::NTHREADS, 1)
    attn_sm90_lab_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const Params p) {
  attn_sm90<D, false, NC, BK, MODE>(&tq, &tk, &tv, p);
}

// The lab mode L4 (kRowK): K9 on NC consumers with the key scales of tsk,
// a (B * H, pitch) fp32 map (attention_sm90_lab.cu)
template <int D, int NC>
__global__ void __launch_bounds__(Plan<D, true, NC, block_k(true, NC), true>::NTHREADS, 1)
    attn_sm90_rowk_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tsk, const Params p) {
  attn_sm90<D, true, NC, block_k(true, NC), kRowK>(&tq, &tk, &tv, p, &tsk);
}

// ---- launches --------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda function, through the runtime's entry
// point (the library links no libcuda)
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(f);
    }
  }
  return fn;
}

// A 4-D map over (D, N, H, B) of `base` with element strides sn, sh, sb:
// boxes of one 128-byte swizzle span by `rows` rows of one head of one
// sample. A dimension of extent 1 takes stride 16.
inline bool encode(EncodeTiled fn, CUtensorMap* map, bool bytes, const void* base, int d, int n,
                   int heads, int batch, int64_t sn, int64_t sh, int64_t sb, int rows) {
  const int64_t es = bytes ? 1 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(n > 1 ? sn * es : 16),
                                 static_cast<cuuint64_t>(heads > 1 ? sh * es : 16),
                                 static_cast<cuuint64_t>(batch > 1 ? sb * es : 16)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(SPAN / es), static_cast<cuuint32_t>(rows), 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// kRowK's key scales: a 2-D map over `rows` fp32 rows of `n` scales each,
// `pitch` floats apart (a multiple of 4: a stride of whole 16 bytes), in
// boxes of one row's `box` scales; the columns past n arrive as zeros.
inline bool encode_scales(EncodeTiled fn, CUtensorMap* map, const void* base, int n, int rows,
                          int64_t pitch, int box) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch * 4)};
  const cuuint32_t boxd[2] = {static_cast<cuuint32_t>(box), 1};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, boxd,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `kernel` with plan L on the tensor maps `maps`, a block per query block
// of one (batch, head); the shared-memory limit set once per device
// (`smem_set`: the instantiation's).
template <typename L, typename Kernel, typename... Maps>
static int launch_plan(Kernel kernel, bool (&smem_set)[MAX_DEVICES], const Params& p, int batch,
                       cudaStream_t stream, const Maps&... maps) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  const dim3 grid((p.nq + L::BQ - 1) / L::BQ, batch * p.heads);
  kernel<<<grid, L::NTHREADS, L::SMEM, stream>>>(maps..., p);
  return static_cast<int>(cudaGetLastError());
}

// Internal linkage: a function-local static of a function with external
// linkage is one object across every library loaded in the process
// (STB_GNU_UNIQUE), so another library's build of this header (attn_tune's
// copies) would mark this library's kernels as set up.
template <int D, bool INT8, int NC>
static int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                  const Params& p, int batch, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  if constexpr (INT8) {
    return launch_plan<Plan<D, true, NC>>(attn_sm90_int8_kernel<D, NC>, smem_set, p, batch, stream,
                                          tq, tk, tv);
  } else {
    return launch_plan<Plan<D, false, NC>>(attn_sm90_bf16_kernel<D>, smem_set, p, batch, stream,
                                           tq, tk, tv);
  }
}

// a lab mode's instantiation: kRowK's (BK its plan's) with its key scales'
// map tsk, the bf16 modes' without
template <int D, int NC, int BK, int MODE>
static int launch_lab_at(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         const CUtensorMap* tsk, const Params& p, int batch, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  if constexpr (MODE == kRowK) {
    return launch_plan<Plan<D, true, NC, BK, true>>(attn_sm90_rowk_kernel<D, NC>, smem_set, p,
                                                    batch, stream, tq, tk, tv, *tsk);
  } else {
    return launch_plan<Plan<D, false, NC, BK>>(attn_sm90_lab_kernel<D, NC, BK, MODE>, smem_set, p,
                                               batch, stream, tq, tk, tv);
  }
}

// The launches of each instantiation, one translation unit per dtype
// (attention_sm90_bf16.cu, attention_sm90_int8.cu) and two for the lab
// modes (attention_sm90_lab.cu: L1, L2, L4 and the lab's dispatch;
// attention_sm90_lab_two_pass.cu: L3) so that the build compiles them side
// by side; cudaErrorInvalidValue for a head dimension, consumer count, mode
// or key tile not instantiated. `tsk`: kRowK's key scales (null otherwise).
int launch_bf16(int d, const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                const Params& p, int batch, cudaStream_t stream);
int launch_int8(int d, int nc, const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                const Params& p, int batch, cudaStream_t stream);
int launch_lab(int d, int mode, int nc, int bk, const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, const CUtensorMap* tsk, const Params& p, int batch,
               cudaStream_t stream);
int launch_two_pass(int d, int nc, int bk, const CUtensorMap& tq, const CUtensorMap& tk,
                    const CUtensorMap& tv, const Params& p, int batch, cudaStream_t stream);

}  // namespace pd_sm90
