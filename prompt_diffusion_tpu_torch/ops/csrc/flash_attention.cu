// Flash attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces two TPU kernels of prompt_diffusion_tpu/ops/flash_attention.py:
//   * flash_attention_packed (_fa_packed_fullk_kernel / _fa_packed_kernel),
//     packed (B, N, H*D) self-attention in the UNet and ControlNet (K1,
//     D = 40 at 64² latents, 80 at 32²);
//   * flash_attention (_fa_kernel), (B, N, H, D) attention of the VAE
//     mid-block (K2, D = 512).
// On the paths K1 and K2 at D 40, 64, 80 and 128 run attention_sm90.cuh's
// `wgmma` kernel and K2 at D = 512 attention_sm90_wide.cuh's
// (ops/flash_attention.py::attention_route), and so do the lab's online
// (L1), no-softmax (L2) and two-pass (L3) modes at the head dimensions
// attention_sm90_lab.cu and _lab_two_pass.cu instantiate. The narrow and
// wide kernels below are their parent designs, kept for head dimensions
// the sm90 kernels do not instantiate (above 128: D = 160, which no path
// runs), and for the lab, chip_smoke.py and tools/attn_tune.py to time
// beside them (ops/flash_attention.py::_parent_launch).
// Packed (B, N, H*D) memory is exactly the (B, N, H, D) layout, so one
// strided kernel serves both and no head transposes are made.
//
// The narrow kernel, with its query and key tiles as template parameters
// and a mode, was the first design of the attention lab kernels of
// tools/attn_variants.py, attn_lab2.py and attn_lab3.py; its three modes
// are the parents of attention_sm90.cuh's lab instantiations:
//   * kOnline: softmax attention with an online softmax (`_online_kernel`
//     with do_softmax=True); K1 was this mode;
//   * kNoSoftmax: O = sum_j bf16(s_ij * scale) V_j, no max, exp or
//     division (`_online_kernel` with do_softmax=False), the lab's L2;
//   * kTwoPass: the "full-K" kernels (`_fullk_kernel`, `_fullk_packed*`,
//     `_fullk_batched_heads`), which hold a whole logits row and take one
//     softmax. A Hopper block cannot hold the row, so it makes two passes
//     over the keys: the exact row maximum first (QK^T only), then
//     exp(s - m), its fp32 sum and bf16 P.V with no rescaling.
// Its tiles are BQ in {64, 128} (4 or 8 warps) and BK in {32, 64, 128};
// any other pair is refused at launch.
//
// Numerics follow the TPU kernels: logits, running max and running sum in
// fp32; P is rounded to bf16 before P.V; the P.V accumulator is fp32 and is
// divided by the running sum once at the end; the sum is taken over the
// fp32 P. exp(s - m) is computed as 2^(s * c - m') with c = scale * log2(e)
// folded into one FFMA per logit; the row maximum is taken over the
// unscaled logits and scaled once, so scale must be positive (checked).
//
// What bounds it on the H100 (`tools/timing.py::roofline`):
//   * D = 40 (K1 at 64², the heaviest call): on paper the exponentials,
//     one per logit: the special-function units give ~3.9e12/s against
//     989 TFLOP/s of bf16 tensor cores, so at (8, 4096, 8, 40) the 1.07 G
//     exponentials (0.275 ms) outweigh the two products (0.174 ms). So the
//     logits never leave registers, the scale costs no extra instruction
//     and the tail mask runs on the last key tile only. Measured on the
//     H100 (`tools/attn_tune.py`), taking the exponentials out changes
//     nothing and taking the P.V products out saves ~30%: the mma.sync
//     products and their shared-memory operand loads bound it, not the
//     special-function units;
//   * D = 512 (K2): the two products, 8x the exponentials' time, so every
//     logit is computed once per block (no column split that recomputes
//     QK^T).
//
// Narrow design (D <= 128):
//   * one block of BQ/16 warps owns BQ query rows of one (batch, head);
//     each warp owns 16 rows from the logits to the output;
//   * tensor-core products are mma.sync m16n8k16 bf16 -> fp32 fed by
//     ldmatrix (.trans for V), whose fragment layouts are documented: Q's
//     A-fragments stay in registers for the whole key loop; the logit tile
//     S (BK/8 tiles x 4 fp32), the row max and sum (reduced over the 4
//     lanes of a row with two shuffles), P (the accumulator layout of two
//     adjacent n8 tiles is the A layout of one k16 step) and the output
//     accumulator (rescaled in place, and only when a row maximum of the
//     warp moved) all stay in registers. Nothing of S, P or O touches
//     shared memory;
//   * K/V tiles stream through a ring of two shared-memory stages with
//     cp.async (16 bytes a thread, predicated, no branch), one block
//     barrier per key tile: tile j+1 loads while tile j computes. The
//     zero-fill form of cp.async pads the head dimension to a multiple of
//     16 (40 -> 48) in shared memory only, and fills the key and query tail
//     rows;
//   * rows are padded by 16 bytes, so the 8 rows of every ldmatrix phase
//     fall on distinct banks;
//   * at K1's D = 40 tiles the registers are capped at 128 so that an SM
//     holds 16 warps (narrow_min_blocks).
// Wide design (128 < D <= 512; K2): one block of 16 warps owns 64 query
// rows and streams 32-key tiles, K through a two-stage cp.async ring and V
// through one stage loaded while Q.K^T runs. Each warp computes the 16 x
// 32 partial logits of one row group over one quarter of the depth, four
// independent accumulators; the four partials of every logit are summed
// in a fixed order through shared memory, so each logit is computed once
// per block. Each warp then takes 4 whole rows for the online softmax
// (max and sum over the 8 lanes of a row) and writes bf16 P and the row
// corrections to shared memory, and finally accumulates P.V for its own
// 32 of the 512 output columns of all 64 rows in registers (64 fp32 a
// thread).
//
// The wrapper checks D % 8 == 0, D <= 512, bf16, 16-byte aligned rows and
// scale > 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Mode { kOnline = 0, kNoSoftmax = 1, kTwoPass = 2 };

constexpr int D_NARROW = 128;  // widest head the register kernel takes
constexpr int D_MAX = 512;     // the wide kernel's Q and K/V tiles must fit
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;

// the wide kernel: 64 query rows, 32-key tiles, 16 warps, Q.K^T split
// over 4 quarters of the depth
constexpr int WQ = 64;
constexpr int WK = 32;
constexpr int WWARPS = 16;
constexpr int WSPLIT = 4;
constexpr int WLDS = WK + 8;  // fp32 partial-logit pitch: float2 stores free of conflicts
constexpr int WLDP = WK + 8;  // bf16 P pitch

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  // element strides of batch, sequence and head; the head dim is dense
  int64_t q_sb, q_sn, q_sh;
  int64_t k_sb, k_sn, k_sh;
  int64_t v_sb, v_sn, v_sh;
  int64_t o_sb, o_sn, o_sh;
  int heads, nq, nk, d;
  int dpad;  // d rounded up to 16 (narrow) or 64 (wide), zero-filled in shared memory
  float scale;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// When `write`, 16 bytes from global to shared memory without a register;
// zeros instead when !ok. Predicated, so a copy costs no branch.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool write, bool ok) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16, %2;\n}\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(ok ? 16 : 0), "r"(static_cast<int>(write))
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 into fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b, the accumulator starting from zero
__device__ __forceinline__ void mma_bf16_zero(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// two fp32 -> one bf16x2 register, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
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

// Issue asynchronous copies of rows [r0, r0 + ROWS) of a strided (rows, d)
// bf16 matrix into shared rows of pitch ld, dpad columns; rows past nrows
// and columns past d are zero-filled. CH >= dpad / 8 is the chunk count a
// row may have: every thread makes the same ROWS * CH / NT copies with
// shifts for index arithmetic and no branch.
template <int ROWS, int NT, int CH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                          int64_t stride, int r0, int nrows, int d, int dpad) {
  static_assert(ROWS * CH % NT == 0, "every thread makes the same number of copies");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const bool ok = r0 + r < nrows && c < d;
    cp_async16(dst + r * ld + c, src + (ok ? (int64_t)(r0 + r) * stride + c : 0), c < dpad, ok);
  }
}

// ---- narrow kernel: D <= 128, S, P and O in registers ---------------------

// Stages of the K/V ring: tile j + NST - 1 loads while tile j computes.
constexpr int NST = 2;

// Shared memory: Q [BQ][ld], then the stages of K [BK][ld] and V [BK][ld].
__host__ inline size_t narrow_smem(int bq, int bk, int dpad) {
  return (size_t)(bq + 2 * NST * bk) * (dpad + 8) * 2;
}

// Blocks an SM must hold at once: at BK <= 64 and DK = 64 (K1 at D = 40)
// the kernel needs about 128 registers, and the cap keeps 16 warps in
// flight, two blocks of 8 or four of 4 (without it K1 runs ~1.5x slower on
// the H100, `tools/attn_tune.py`); the wider tiles take what they need.
__host__ __device__ constexpr int narrow_min_blocks(int bq, int bk, int dk) {
  return bk <= 64 && dk == 64 ? 256 / bq : 1;
}

// BQ query rows (BQ/16 warps, 16 rows each), BK-key tiles, DK >= dpad the
// register capacity of the head dimension (64 or 128).
template <int BQ, int BK, int DK, int MODE>
__global__ void __launch_bounds__(BQ * 2, narrow_min_blocks(BQ, BK, DK))
    fa_narrow_kernel(Params p) {
  constexpr int NT = BQ * 2;
  constexpr int KS = DK / 16;  // k16 steps of Q.K^T
  constexpr int NO = DK / 8;   // 8-column output tiles
  constexpr int NS = BK / 8;   // 8-key logit tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = p.dpad + 8;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sKV = sQ + BQ * ld;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16;  // first query row of this warp
  const int g = lane >> 2, t = lane & 3;     // fragment row and column pair
  // ldmatrix addressing of this lane: row within a 16-row piece, column half
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  const int krow = (lane & 7) + (lane >> 4) * 8;  // K: two n8 tiles per x4
  const int kcol = ((lane >> 3) & 1) * 8;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;

  const int ksteps = p.dpad / 16;
  const int nkt = (p.nk + BK - 1) / BK;
  const float sl2 = p.scale * LOG2E;

  auto stage_k = [&](int j) { return sKV + (size_t)(j % NST) * 2 * BK * ld; };
  auto stage_v = [&](int j) { return stage_k(j) + BK * ld; };
  // one copy group per tile index, empty past the last tile, so that
  // wait_group<NST - 2> at the top of tile j always means "tile j is here"
  auto issue = [&](int j, bool with_v) {
    if (j < nkt) {
      load_rows<BK, NT, DK / 8>(stage_k(j), ld, kb, p.k_sn, j * BK, p.nk, p.d, p.dpad);
      if (with_v) load_rows<BK, NT, DK / 8>(stage_v(j), ld, vb, p.v_sn, j * BK, p.nk, p.d, p.dpad);
    }
    cp_async_commit();
  };

  uint32_t qf[KS][4];
  auto load_q_frags = [&]() {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < ksteps) ldsm_x4(qf[kk], sQ + (wrow + lrow) * ld + kk * 16 + lcol);
    }
  };

  // S = Q K^T of key tile j for the warp's 16 rows, unscaled
  auto qk = [&](float (&s)[NS][4], int j) {
    const __nv_bfloat16* sK = stage_k(j);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < ksteps) {
#pragma unroll
        for (int n2 = 0; n2 < NS / 2; ++n2) {
          uint32_t kf[4];
          ldsm_x4(kf, sK + (n2 * 16 + krow) * ld + kk * 16 + kcol);
          if (kk == 0) {
            mma_bf16_zero(s[2 * n2], qf[kk], kf[0], kf[1]);
            mma_bf16_zero(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
          } else {
            mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
            mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
          }
        }
      }
    }
  };

  // the key tail of the last tile to -inf
  auto mask_tail = [&](float (&s)[NS][4], int j) {
    if ((j + 1) * BK <= p.nk) return;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int c = j * BK + n * 8 + 2 * t;
      if (c >= p.nk) s[n][0] = s[n][2] = -INFINITY;
      if (c + 1 >= p.nk) s[n][1] = s[n][3] = -INFINITY;
    }
  };

  // fold tile j's logits into the row maxima of rows g and g + 8, in log2
  // units: scale * log2(e) > 0 (the wrapper checks scale > 0), so the
  // maximum of the scaled logits is the scaled maximum
  auto row_max = [&](float (&mx)[2], const float (&s)[NS][4]) {
    float r0 = -INFINITY, r1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      r0 = fmaxf(r0, fmaxf(s[n][0], s[n][1]));
      r1 = fmaxf(r1, fmaxf(s[n][2], s[n][3]));
    }
    mx[0] = fmaxf(mx[0], quad_max(r0) * sl2);
    mx[1] = fmaxf(mx[1], quad_max(r1) * sl2);
  };

  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  load_rows<BQ, NT, DK / 8>(sQ, ld, qb, p.q_sn, q0, p.nq, p.d, p.dpad);
  bool q_ready = false;

  if constexpr (MODE == kTwoPass) {
    // pass 1: the exact row maximum of the scaled logits
    for (int j = 0; j < NST - 1; ++j) issue(j, false);
    for (int j = 0; j < nkt; ++j) {
      cp_async_wait<NST - 2>();
      __syncthreads();  // tile j visible; every warp is done with tile j - 1
      if (j == 0) load_q_frags();
      issue(j + NST - 1, false);
      float s[NS][4];
      qk(s, j);
      mask_tail(s, j);
      row_max(m, s);
    }
    q_ready = true;
    cp_async_wait<0>();
    __syncthreads();  // the last tile's readers are done before pass 2 refills
  }

  for (int j = 0; j < NST - 1; ++j) issue(j, true);
  for (int j = 0; j < nkt; ++j) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile j visible; every warp is done with tile j - 1
    if (!q_ready && j == 0) load_q_frags();
    issue(j + NST - 1, true);
    float s[NS][4];
    qk(s, j);
    if (MODE == kNoSoftmax) {
      // P = s * scale; the tail's K and V rows are zeros, so its terms
      // vanish unmasked
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= p.scale;
      }
    } else {
      mask_tail(s, j);
    }
    if (MODE == kOnline) {
      float mx[2] = {m[0], m[1]};
      row_max(mx, s);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        corr[r] = ex2(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
        m[r] = mx[r];
        l[r] *= corr[r];
      }
      // rescale only when a row maximum of the warp moved
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          if (n * 8 < p.d) {
            o[n][0] *= corr[0];
            o[n][1] *= corr[0];
            o[n][2] *= corr[1];
            o[n][3] *= corr[1];
          }
        }
      }
    }
    if (MODE != kNoSoftmax) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {  // p = 2^(s * scale * log2(e) - m), one FFMA
        s[n][0] = ex2(fmaf(s[n][0], sl2, -m[0]));
        s[n][1] = ex2(fmaf(s[n][1], sl2, -m[0]));
        s[n][2] = ex2(fmaf(s[n][2], sl2, -m[1]));
        s[n][3] = ex2(fmaf(s[n][3], sl2, -m[1]));
        l[0] += s[n][0] + s[n][1];
        l[1] += s[n][2] + s[n][3];
      }
    }

    // O += bf16(P) V: logit tiles 2kk and 2kk+1 are the A fragment of k-step kk
    const __nv_bfloat16* sV = stage_v(j);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        if (n2 * 16 < p.d) {
          uint32_t vf[4];
          ldsm_x4_t(vf, sV + (kk * 16 + lrow) * ld + n2 * 16 + lcol);
          mma_bf16(o[2 * n2], a, vf[0], vf[1]);
          if (n2 * 16 + 8 < p.d) mma_bf16(o[2 * n2 + 1], a, vf[2], vf[3]);
        }
      }
    }
  }

  // O / l, stored as bf16 pairs straight from the accumulators
  if (MODE != kNoSoftmax) {
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wrow + g + 8 * r;
    if (qi >= p.nq) continue;
    __nv_bfloat16* orow = ob + (int64_t)qi * p.o_sn;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < p.d) {
        float x0 = o[n][2 * r], x1 = o[n][2 * r + 1];
        if (MODE != kNoSoftmax) {
          x0 = x0 / l[r];
          x1 = x1 / l[r];
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// ---- wide kernel: 128 < D <= 512, each logit once per block ----------------

struct WideLayout {
  int ld;
  size_t off_k, off_v, off_s, off_p, off_corr, off_l, total;
};

__host__ __device__ inline WideLayout wide_layout(int dpad) {
  WideLayout L;
  L.ld = dpad + 8;
  size_t off = (size_t)WQ * L.ld * 2;                           // Q
  L.off_k = off;    off += (size_t)2 * WK * L.ld * 2;           // two K stages
  L.off_v = off;    off += (size_t)WK * L.ld * 2;               // one V stage
  L.off_s = off;    off += (size_t)WSPLIT * WQ * WLDS * 4;      // partial logits
  L.off_p = off;    off += (size_t)WQ * WLDP * 2;               // bf16 P
  L.off_corr = off; off += (size_t)WQ * 4;                      // per-row correction
  L.off_l = off;    off += (size_t)WQ * 4;                      // row sums
  L.total = off;
  return L;
}

__global__ void __launch_bounds__(WWARPS * 32, 1) fa_wide_kernel(Params p) {
  constexpr int NT = WWARPS * 32;
  constexpr int CH = D_MAX / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const WideLayout L = wide_layout(p.dpad);
  const int ld = L.ld;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sKs = reinterpret_cast<__nv_bfloat16*>(smem + L.off_k);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L.off_v);
  float* sS = reinterpret_cast<float*>(smem + L.off_s);  // [WSPLIT][WQ][WLDS]
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L.off_p);
  float* sCorr = reinterpret_cast<float*>(smem + L.off_corr);
  float* sL = reinterpret_cast<float*>(smem + L.off_l);

  const int q0 = blockIdx.x * WQ;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  const int krow = (lane & 7) + (lane >> 4) * 8;
  const int kcol = ((lane >> 3) & 1) * 8;
  // Q.K^T: this warp's 16 rows and one quarter of the depth, all 32 keys
  const int srow = (warp & 3) * 16;
  const int part = warp >> 2;
  const int kq = p.dpad / 16 / WSPLIT;  // k16 steps per quarter
  const int kk0 = part * kq;
  // softmax: 4 whole rows per warp, 4 keys per lane
  const int frow = warp * 4 + (lane >> 3);
  const int fkey = (lane & 7) * 4;
  // P.V: this warp's 32 output columns of all 64 rows
  const int col0 = warp * 32;
  const bool has_cols = col0 < p.d;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;

  const int nkt = (p.nk + WK - 1) / WK;
  const float sl2 = p.scale * LOG2E;
  auto stage_k = [&](int j) { return sKs + (size_t)(j & 1) * WK * ld; };

  float m = -INFINITY;  // the running maximum of row frow, log2 units
  float l = 0.f;        // this lane's share of its sum
  float o[4][4][4];     // [row tile][8-column tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int n = 0; n < 4; ++n) o[i][n][0] = o[i][n][1] = o[i][n][2] = o[i][n][3] = 0.f;
  }

  // groups in flight: Q with K_0; then per tile V_j, then K_{j+1}
  load_rows<WQ, NT, CH>(sQ, ld, qb, p.q_sn, q0, p.nq, p.d, p.dpad);
  load_rows<WK, NT, CH>(stage_k(0), ld, kb, p.k_sn, 0, p.nk, p.d, p.dpad);
  cp_async_commit();
  for (int j = 0; j < nkt; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // K_j visible; tile j - 1 is done everywhere
    load_rows<WK, NT, CH>(sV, ld, vb, p.v_sn, j * WK, p.nk, p.d, p.dpad);
    cp_async_commit();
    if (j + 1 < nkt) {
      load_rows<WK, NT, CH>(stage_k(j + 1), ld, kb, p.k_sn, (j + 1) * WK, p.nk, p.d, p.dpad);
    }
    cp_async_commit();

    // partial logits of this warp's quarter of the depth, 4 accumulators
    const __nv_bfloat16* sK = stage_k(j);
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
    for (int kk = kk0; kk < kk0 + kq; ++kk) {
      uint32_t a[4], k01[4], k23[4];
      ldsm_x4(a, sQ + (srow + lrow) * ld + kk * 16 + lcol);
      ldsm_x4(k01, sK + krow * ld + kk * 16 + kcol);
      ldsm_x4(k23, sK + (16 + krow) * ld + kk * 16 + kcol);
      mma_bf16(s[0], a, k01[0], k01[1]);
      mma_bf16(s[1], a, k01[2], k01[3]);
      mma_bf16(s[2], a, k23[0], k23[1]);
      mma_bf16(s[3], a, k23[2], k23[3]);
    }
    float* sSp = sS + (size_t)part * WQ * WLDS;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<float2*>(sSp + (srow + g) * WLDS + n * 8 + 2 * t) =
          make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(sSp + (srow + g + 8) * WLDS + n * 8 + 2 * t) =
          make_float2(s[n][2], s[n][3]);
    }
    __syncthreads();  // the partial logits of the tile

    // online softmax over whole rows: the 4 partials summed in a fixed order
    float x[4];
    {
      float4 acc = *reinterpret_cast<const float4*>(sS + frow * WLDS + fkey);
#pragma unroll
      for (int q = 1; q < WSPLIT; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(sS + (q * WQ + frow) * WLDS + fkey);
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      x[0] = acc.x; x[1] = acc.y; x[2] = acc.z; x[3] = acc.w;
    }
    if ((j + 1) * WK > p.nk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j * WK + fkey + e >= p.nk) x[e] = -INFINITY;
      }
    }
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4)) * sl2);  // scale > 0
    const float corr = ex2(m - mx);  // 0 on the first tile (m = -inf)
    m = mx;
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = ex2(fmaf(x[e], sl2, -m));
    l = l * corr + ((x[0] + x[1]) + (x[2] + x[3]));
    *reinterpret_cast<uint2*>(sP + frow * WLDP + fkey) =
        make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
    if ((lane & 7) == 0) sCorr[frow] = corr;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // V_j
    __syncthreads();  // P, the corrections and V_j

    // O = O * corr + P V for this warp's 32 columns
    if (has_cols) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float c0 = sCorr[i * 16 + g], c1 = sCorr[i * 16 + g + 8];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          o[i][n][0] *= c0;
          o[i][n][1] *= c0;
          o[i][n][2] *= c1;
          o[i][n][3] *= c1;
        }
      }
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) {
        uint32_t vf[2][4];
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          ldsm_x4_t(vf[n2], sV + (kk * 16 + lrow) * ld + col0 + n2 * 16 + lcol);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t a[4];
          ldsm_x4(a, sP + (i * 16 + lrow) * WLDP + kk * 16 + lcol);
#pragma unroll
          for (int n2 = 0; n2 < 2; ++n2) {
            mma_bf16(o[i][2 * n2], a, vf[n2][0], vf[n2][1]);
            mma_bf16(o[i][2 * n2 + 1], a, vf[n2][2], vf[n2][3]);
          }
        }
      }
    }
  }

  // the row sums over the 8 lanes of a row
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l += __shfl_xor_sync(0xffffffffu, l, 4);
  if ((lane & 7) == 0) sL[frow] = l;
  __syncthreads();
  if (!has_cols) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i * 16 + g + 8 * r;
      const int qi = q0 + row;
      if (qi >= p.nq) continue;
      const float lr = sL[row];
      __nv_bfloat16* orow = ob + (int64_t)qi * p.o_sn;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = col0 + n * 8 + 2 * t;
        if (c < p.d) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(o[i][n][2 * r] / lr, o[i][n][2 * r + 1] / lr);
        }
      }
    }
  }
}

// ---- launches --------------------------------------------------------------

template <int BQ, int BK, int DK, int MODE>
int launch_narrow(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = narrow_smem(BQ, BK, p.dpad);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fa_narrow_kernel<BQ, BK, DK, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nq + BQ - 1) / BQ, batch * p.heads);
  fa_narrow_kernel<BQ, BK, DK, MODE><<<grid, BQ * 2, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ, int BK, int MODE>
int launch_dk(const Params& p, int batch, cudaStream_t s) {
  return p.dpad <= 64 ? launch_narrow<BQ, BK, 64, MODE>(p, batch, s)
                      : launch_narrow<BQ, BK, 128, MODE>(p, batch, s);
}

template <int MODE>
int launch_tiles(const Params& p, int batch, int bq, int bk, cudaStream_t s) {
  if (bq == 64) {
    if (bk == 32) return launch_dk<64, 32, MODE>(p, batch, s);
    if (bk == 64) return launch_dk<64, 64, MODE>(p, batch, s);
    if (bk == 128) return launch_dk<64, 128, MODE>(p, batch, s);
  } else if (bq == 128) {
    if (bk == 32) return launch_dk<128, 32, MODE>(p, batch, s);
    if (bk == 64) return launch_dk<128, 64, MODE>(p, batch, s);
    if (bk == 128) return launch_dk<128, 128, MODE>(p, batch, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_wide(const Params& p, int batch, cudaStream_t stream) {
  const WideLayout L = wide_layout(p.dpad);
  if (L.total > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fa_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nq + WQ - 1) / WQ, batch * p.heads);
  fa_wide_kernel<<<grid, WWARPS * 32, L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* pd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// D <= 128: the narrow kernel; mode 0 online softmax, 1 no softmax, 2 two
// passes; (block_q, block_k) one of the instantiated tiles. 128 < D <= 512:
// the wide kernel, online softmax at (64, 32) only.
extern "C" int pd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int batch, int heads, int nq, int nk, int d,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sn, int64_t k_sh,
    int64_t v_sb, int64_t v_sn, int64_t v_sh,
    int64_t o_sb, int64_t o_sn, int64_t o_sh,
    float scale, int mode, int block_q, int block_k, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > D_MAX || nq <= 0 || nk <= 0 || batch <= 0 ||
      heads <= 0 || (int64_t)batch * heads > 65535 || !(scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.heads = heads; p.nq = nq; p.nk = nk; p.d = d;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > D_NARROW) {
    if (mode != kOnline || block_q != WQ || block_k != WK) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.dpad = (d + 63) / 64 * 64;
    return launch_wide(p, batch, s);
  }
  p.dpad = (d + 15) / 16 * 16;
  switch (mode) {
    case kOnline: return launch_tiles<kOnline>(p, batch, block_q, block_k, s);
    case kNoSoftmax: return launch_tiles<kNoSoftmax>(p, batch, block_q, block_k, s);
    case kTwoPass: return launch_tiles<kTwoPass>(p, batch, block_q, block_k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
