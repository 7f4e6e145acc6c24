// int8-QK^T attention forward for Hopper (sm_90a) over packed (B, N, H*D)
// tensors: bf16 Q and V, int8 K codes with one scale per (batch, head), or
// one per key row in the lab mode below; and its prologue, which quantizes
// K.
//
// Replaces the TPU kernel prompt_diffusion_tpu/ops/flash_attention.py::
// flash_attention_packed_int8 (_fa_packed_fullk_int8_kernel): the joint
// attention of every SD3 MMDiT and ControlNet block, and of the MiDaS ViT,
// in the int8 serving mode. On the paths its prologue (K9p, below) runs
// before attention_sm90.cuh's `wgmma` kernel (ops/flash_attention.py::
// attention_route); `int8_attn_kernel` below is that kernel's parent
// design, kept for the lab, chip_smoke.py and tools/attn_tune.py to time
// beside it (ops/flash_attention.py::_int8_parent_launch). Per (batch,
// head) it computes, in the TPU kernel's order:
//
//   sq[i]   = max(max_d |q[i, d]| / 127, 1e-8)           (IEEE division)
//   qc[i,d] = clip(rint(q[i, d] / sq[i]), -127, 127)       (int8)
//   s[i,j]  = f32(sum_d qc[i,d] * kc[j,d]) * (sq[i] * (skh * scale))
//   m[i]    = max_j s[i, j]
//   p[i,j]  = exp(s[i, j] - m[i])                           (fp32)
//   l[i]    = sum_j p[i, j]                                 (fp32)
//   o[i]    = bf16( (sum_j bf16(p[i,j]) * v[j]) / l[i] )   (fp32 sum)
//
// The TPU kernel holds a whole logits row, so it rounds P to bf16 against
// the final row maximum. This kernel makes one pass with an online softmax
// and rounds P to bf16 against the running maximum, as K1 does: the fp32 P
// and l agree with the full-row order up to the exponential's rounding, and
// bf16(P) differs by at most one bf16 step where the maximum later moved.
//
// The prologue (`k_head_quant_kernel`, K9p) is the K quantization that the
// JAX package computes in XLA in the same Python function
// (`flash_attention.py:391-394`): skh[b, h] = max(amax / 127, 1e-8) over
// the head's (Nk, D) values, codes rint(k / skh) clipped to +-127, written
// contiguous (B, Nk, H*D) whatever K's strides, so the attention kernel's
// 16-byte copies of K work on the ViT's qkv column slices too. Bound by
// bytes: one read of bf16 K and one write of its codes, 0.0122 ms at the
// SD3 joint shape (B 2, N 4429, H*D 1536). One cooperative launch of an
// all-resident grid (`quant_k_plan` in ops/flash_attention.py), K5's
// pattern over (batch, head) instead of (sample, group): block j of
// sample b owns a contiguous range of its key rows, thread (r, v) vector v
// (8 values of head v / (D/8)) of rows r, r + R, ...; each block writes its
// |k| amax per head to its workspace slot (no atomic, no zeroed buffer);
// one grid barrier; each block takes the max of its sample's slots per head
// (a max: the same bits in any order), forms skh by IEEE division, and
// writes the codes of its rows, re-read from L2 (the SD3 K is 27 MB), with
// the quotient k * (1/skh) and one FMA correction (`rq::quotient`, equal
// to __fdiv_rn). Codes and scales are bit-equal to `_quant_k_per_head`.
// Head widths 32, 40, 64, 80 and 128 (the SD1.5 UNet's 40 and 80 under
// `int8_attention`): a thread's 16-byte vector holds 8 values of one head
// whatever D (D % 8 == 0; 5 and 10 vectors a head at 40 and 80), so the
// per-head amax and the exchange are the same code at every width. The
// codes' heads lie `code_d` bytes apart (D, or for the sm90 kernel's
// tensor map at D = 40 48: attention_sm90.cuh), the bytes past D of a
// head unwritten.
// The per-row mode of the lab (`k_row_codes_kernel`) is one plain launch:
// a row's scale is a shuffle across the D/8 lanes that hold it (D/8
// divides 32: 32, 64 and 128 only, as the parent kernel).
//
// What bounds it on the H100 (`tools/timing.py::roofline`): at the SD3
// joint shape (B 2, N 4429, H 24, D 64) the 0.94 G exponentials, ~0.24 ms
// at ~3.9e12/s, against ~0.06 ms of int8 and ~0.12 ms of bf16 tensor work
// and ~0.02 ms of bytes. So every logit lives in registers from the product
// to P, and a probability costs one FFMA into ex2. Design (K1's narrow
// kernel, `flash_attention.cu`, with an int8 first product):
//   * one block of BQ/16 warps (BQ = 128 or 64 query rows) owns a query
//     tile of one (batch, head); each warp owns 16 rows from the logits to
//     the output;
//   * the block copies its Q tile (bf16) in with cp.async; each thread then
//     quantizes, straight from shared memory into registers, the values of
//     its rows g and g + 8 that its A fragments hold (a quad of lanes holds
//     whole rows, so the row amax is two shuffles), with the IEEE division:
//     the codes equal the plain version's bit for bit, and Q's int8 A
//     fragments stay in registers for the whole key loop;
//   * Q.K^T is mma.sync m16n8k32 s8 -> s32. ldmatrix (b16, not transposed)
//     of an int8 tile whose rows are 16-byte chunks gives the s8 B fragment
//     of K read as column-major (key g, depth 4t..4t+3). The s32
//     accumulator has the (row, column) layout of K1's fp32 m16n8k16
//     accumulator, so the logit tile turns into P's bf16 A fragment as in
//     K1, and P.V is K1's mma.sync m16n8k16 bf16 with ldmatrix.trans on V;
//   * one pass over the keys with an online softmax. skh * scale > 0 and
//     sq > 0, so the row maximum is taken over the exact integer sums (as
//     floats: |s| < 2^22, converted exactly with two full-rate adds) and
//     scaled once; each probability is ex2(fma(s, c_r, -m_r)) with
//     c_r = sq_r * (skh * scale) * log2(e). O and l are rescaled only when
//     a row maximum of the warp moved;
//   * K/V tiles of 64 keys stream through a two-stage cp.async ring, one
//     block barrier per tile: tile j + 1 loads while tile j computes. Rows
//     are padded by 16 bytes, so the 8 rows of every ldmatrix phase fall on
//     distinct banks;
//   * the key tail is masked (-inf) on the last tile, in the maximum and in
//     the sum: a zero-filled key row has an integer sum of 0, which may lie
//     above every real logit of a row. The query tail's zero rows (sq =
//     1e-8, codes 0) are computed and not stored;
//   * at D <= 64 the registers are capped at 128 so that an SM holds 16
//     warps.
//
// ROWK mode: tools/attn_int8_lab.py's v2 (`_kernel_v2`, L4; on the card it
// runs attention_sm90.cuh's per-row-K mode, and this one beside it), K
// quantized per (batch, key row, head) by `k_row_codes_kernel` (sk (B, H)
// rows of Nk scales, at pitch Nk here); the logits are f32(s32) * (sq[i] *
// sk[j]) * scale in that order, so the row maximum is taken over the
// scaled logits. The block stages the key tile's BK scales beside the
// codes; everything else is K9's. The lab's v3 (`_kernel_v3`, per-head
// scales) is K9 itself.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "quant_common.cuh"

namespace {

constexpr int BK = 64;   // keys per tile
constexpr int NST = 2;   // stages of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr int QK_THREADS = 256;      // threads of a per-row codes block
constexpr int HQ_MAX_THREADS = 512;  // threads of a K9p block, at most
constexpr int HQ_MAX_HEADS = 128;    // H * D / 8 <= HQ_MAX_THREADS at D = 32
constexpr int HQ_UNROLL = 4;         // key rows a K9p thread loads at once
constexpr int HQ_MERGE_LOADS = 8;    // block amaxes a K9p thread loads at once in the merge

struct Params {
  const __nv_bfloat16* q;  // (B, Nq, H*D)
  const int8_t* k;         // (B, Nk, H*D) codes
  const float* sk;         // (B, H) K scales, or (B, H, Nk) in ROWK mode
  const __nv_bfloat16* v;  // (B, Nk, H*D)
  __nv_bfloat16* o;        // (B, Nq, H*D)
  // element strides of batch and sequence; heads are D-wide column slices
  int64_t q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn;
  int heads, nq, nk;
  float scale;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without a register; zeros when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes likewise (the ROWK mode's key scales)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// c += a (16x32, row-major) * b (32x8, column-major), int8 into int32
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b, the accumulator starting from zero
__device__ __forceinline__ void mma_s8_zero(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 into fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// f32(s) for |s| < 2^22, exactly, with an integer and a float add (the
// bits of 1.5 * 2^23 plus s are the float 1.5 * 2^23 + s)
__device__ __forceinline__ float s32_to_f32(int s) {
  return __int_as_float(s + 0x4B400000) - 12582912.f;
}

// the int8 code of x at scale s: clip(rint(x / s), -127, 127), IEEE division
__device__ __forceinline__ uint32_t code8(float x, float s) {
  const float c = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(c)) & 0xffu;
}

// four bf16 (8 bytes) as floats
__device__ __forceinline__ void load4(float (&x)[4], const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// Copies of rows [r0, r0 + ROWS) of a strided matrix, CH 16-byte chunks a
// row, into shared rows of `ldb` bytes; rows past nrows are zero-filled.
// UNROLL 1 keeps the loop rolled: in the key loop, unrolled copies keep
// each copy's addresses in registers across tiles, and at 4 warps a block
// (4 V copies a thread) that spills under the 128-register cap.
template <int ROWS, int CH, int NT, int UNROLL>
__device__ __forceinline__ void load_rows(unsigned char* dst, int ldb, const unsigned char* src,
                                          int64_t stride_b, int r0, int nrows) {
#pragma unroll (UNROLL)
  for (int it = 0; it < (ROWS * CH + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (ROWS * CH % NT == 0 || i < ROWS * CH) {
      const int r = i / CH, c = (i % CH) * 16;
      const bool ok = r0 + r < nrows;
      cp_async16(dst + r * ldb + c, src + (ok ? (int64_t)(r0 + r) * stride_b + c : 0), ok);
    }
  }
}

// blocks of BQ rows an SM must hold at once: 16 warps at D <= 64, whose
// registers then stay at <= 128; D = 128 takes what it needs
__host__ __device__ constexpr int min_blocks(int d, int bq) { return d <= 64 ? 256 / bq : 1; }

template <int D, int BQ, bool ROWK>
struct Layout {
  static constexpr int LDQ = D + 8;   // bf16 Q pitch (elements)
  static constexpr int LDK = D + 16;  // int8 K pitch (bytes)
  static constexpr int LDV = D + 8;   // bf16 V pitch (elements)
  static constexpr int OFF_V = BK * LDK;
  static constexpr int OFF_S = OFF_V + BK * LDV * 2;
  static constexpr int STAGE = OFF_S + (ROWK ? BK * 4 : 0);
  static constexpr int Q_BYTES = BQ * LDQ * 2;
  static constexpr size_t TOTAL = (size_t)Q_BYTES + NST * STAGE;
};

template <int D, int BQ, bool ROWK>
__global__ void __launch_bounds__(BQ * 2, min_blocks(D, BQ)) int8_attn_kernel(Params p) {
  using L = Layout<D, BQ, ROWK>;
  constexpr int NT = BQ * 2;
  constexpr int KS = D / 32;  // k32 steps of Q.K^T
  constexpr int NO = D / 8;   // 8-column output tiles
  constexpr int NS = BK / 8;  // 8-key logit tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const __nv_bfloat16* sQ = reinterpret_cast<const __nv_bfloat16*>(smem);
  unsigned char* stages = smem + L::Q_BYTES;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16;  // first query row of this warp
  const int g = lane >> 2, t = lane & 3;     // fragment row and column group
  // ldmatrix addressing of this lane: V (.trans) rows and column half; K
  // rows (two n8 tiles per x4) and byte half of the k32 step
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  const int krow = (lane & 7) + (lane >> 4) * 8;
  const int kcol = ((lane >> 3) & 1) * 16;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * D;
  const int8_t* kb = p.k + b * p.k_sb + h * D;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * D;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * D;
  const float* skb = ROWK ? p.sk + (int64_t)(b * p.heads + h) * p.nk : p.sk;  // ROWK: row scales
  const float hs = ROWK ? 0.f : __fmul_rn(p.sk[b * p.heads + h], p.scale);  // skh * scale
  const int nkt = (p.nk + BK - 1) / BK;

  auto stage = [&](int j) { return stages + (j % NST) * L::STAGE; };
  // one copy group per tile index, empty past the last tile, so that
  // wait_group 0 at the top of tile j means "tile j is here"
  auto issue = [&](int j) {
    if (j < nkt) {
      unsigned char* st = stage(j);
      load_rows<BK, D / 16, NT, 1>(st, L::LDK, reinterpret_cast<const unsigned char*>(kb),
                                   p.k_sn, j * BK, p.nk);
      load_rows<BK, D / 8, NT, 1>(st + L::OFF_V, L::LDV * 2,
                                  reinterpret_cast<const unsigned char*>(vb), p.v_sn * 2, j * BK,
                                  p.nk);
      if (ROWK && threadIdx.x < BK) {
        const int c = j * BK + threadIdx.x;
        cp_async4(st + L::OFF_S + threadIdx.x * 4, skb + (c < p.nk ? c : 0), c < p.nk);
      }
    }
    cp_async_commit();
  };

  // the Q tile travels in the first copy group, with key tile 0
  load_rows<BQ, D / 8, NT, 8>(smem, L::LDQ * 2, reinterpret_cast<const unsigned char*>(qb),
                              p.q_sn * 2, q0, p.nq);
  issue(0);

  uint32_t qa[KS][4];  // Q's s8 A fragments: rows g, g + 8; bytes 4t.. and 16 + 4t..
  float c[2];          // per head: sq * (skh * scale) * log2(e); ROWK: sq
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};              // this lane's share of the row sums
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // quantize rows g and g + 8 of the warp straight into the A fragments
  auto quantize_q = [&]() {
    const __nv_bfloat16* rp[2] = {sQ + (wrow + g) * L::LDQ, sQ + (wrow + g + 8) * L::LDQ};
    float amax[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x[4];
          load4(x, rp[r] + kk * 32 + half * 16 + 4 * t);
          amax[r] = fmaxf(amax[r], fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])),
                                         fmaxf(fabsf(x[2]), fabsf(x[3]))));
        }
      }
    }
    float sq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sq[r] = fmaxf(__fdiv_rn(quad_max(amax[r]), 127.f), 1e-8f);
      c[r] = ROWK ? sq[r] : __fmul_rn(__fmul_rn(sq[r], hs), LOG2E);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x[4];
          load4(x, rp[r] + kk * 32 + half * 16 + 4 * t);
          qa[kk][2 * half + r] = code8(x[0], sq[r]) | (code8(x[1], sq[r]) << 8) |
                                 (code8(x[2], sq[r]) << 16) | (code8(x[3], sq[r]) << 24);
        }
      }
    }
  };

  cp_async_wait_all();
  __syncthreads();  // the Q tile and key tile 0 visible
  issue(1);         // tile 1 loads while Q is quantized and tile 0 computes
  quantize_q();
  for (int j = 0; j < nkt; ++j) {
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();  // tile j visible; every warp is done with tile j - 1
      issue(j + 1);
    }
    const unsigned char* st = stage(j);

    // S = Qc Kc^T of key tile j for the warp's 16 rows, int32
    int s[NS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t kf[4];
        ldsm_x4(kf, st + (n2 * 16 + krow) * L::LDK + kk * 32 + kcol);
        if (kk == 0) {
          mma_s8_zero(s[2 * n2], qa[kk], kf[0], kf[1]);
          mma_s8_zero(s[2 * n2 + 1], qa[kk], kf[2], kf[3]);
        } else {
          mma_s8(s[2 * n2], qa[kk], kf[0], kf[1]);
          mma_s8(s[2 * n2 + 1], qa[kk], kf[2], kf[3]);
        }
      }
    }

    // the logits as floats: per head the integer sums (scaled in the
    // exponent), in ROWK mode the scaled logits in log2 units; the key tail
    // of the last tile to -inf
    const float* sks = reinterpret_cast<const float*>(st + L::OFF_S);
    const bool tail = (j + 1) * BK > p.nk;
    float x[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int col = n * 8 + 2 * t;
      float2 skc = make_float2(0.f, 0.f);
      if (ROWK) skc = *reinterpret_cast<const float2*>(sks + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float f = s32_to_f32(s[n][e]);
        if (ROWK) {
          const float skj = (e & 1) ? skc.y : skc.x;
          x[n][e] = __fmul_rn(__fmul_rn(f, __fmul_rn(c[e >> 1], skj)), p.scale) * LOG2E;
        } else {
          x[n][e] = f;
        }
      }
      if (tail) {
        if (j * BK + col >= p.nk) x[n][0] = x[n][2] = -INFINITY;
        if (j * BK + col + 1 >= p.nk) x[n][1] = x[n][3] = -INFINITY;
      }
    }

    // online softmax: the new row maxima, the correction of O and l
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(x[n][2 * r], x[n][2 * r + 1]));
      mx = quad_max(mx);
      if (!ROWK) mx *= c[r];  // c > 0: the maximum of the scaled logits
      mx = fmaxf(m[r], mx);
      corr[r] = ex2(m[r] - mx);  // 0 on the first tile (m = -inf)
      m[r] = mx;
      l[r] *= corr[r];
    }
    // rescale only when a row maximum of the warp moved
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        x[n][e] = ROWK ? ex2(x[n][e] - m[r]) : ex2(fmaf(x[n][e], c[r], -m[r]));
      }
      l[0] += x[n][0] + x[n][1];
      l[1] += x[n][2] + x[n][3];
    }

    // O += bf16(P) V: logit tiles 2kk and 2kk + 1 are the A fragment of k-step kk
    const __nv_bfloat16* sV = reinterpret_cast<const __nv_bfloat16*>(st + L::OFF_V);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
      a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
      a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
      a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, sV + (kk * 16 + lrow) * L::LDV + n2 * 16 + lcol);
        mma_bf16(o[2 * n2], a, vf[0], vf[1]);
        mma_bf16(o[2 * n2 + 1], a, vf[2], vf[3]);
      }
    }
  }

  // O / l, stored as bf16 pairs straight from the accumulators
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wrow + g + 8 * r;
    if (qi >= p.nq) continue;
    __nv_bfloat16* orow = ob + (int64_t)qi * p.o_sn;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    }
  }
}

// ---- the prologue: K to int8 -----------------------------------------------

__device__ __forceinline__ float abs_max8(const float (&x)[8]) {
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(x[e]));
  return m;
}

__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// K9p: K's per-head quantization (see the top of the file). Block blk =
// b * bps + j owns key rows [j nk / bps, (j + 1) nk / bps) of sample b.
struct HeadQuantParams {
  const __nv_bfloat16* k;  // (B, Nk, H*D), element strides k_sb, k_sn
  int64_t k_sb, k_sn;
  int heads, nk;
  int cv, rows, bps;  // 16-byte vectors per key row; rows in flight; blocks per sample
  float* ws;          // grid * heads block amaxes
  float* sk;          // (B, H)
  int8_t* codes;      // (B, Nk, H, code_d) bytes, the first D of each head written
  int code_d;         // bytes from one head's codes to the next's: D, or more
};

// the int8 code of x at scale s (r = 1/s): clip(rint(x / s), -127, 127)
// with the IEEE quotient
__device__ __forceinline__ uint32_t code8r(float x, float s, float r) {
  const float c = fminf(fmaxf(rintf(rq::quotient(x, s, r)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(c)) & 0xffu;
}

template <int D>
__global__ void __launch_bounds__(HQ_MAX_THREADS) k_head_quant_kernel(const HeadQuantParams p) {
  constexpr int CH = D / 8;  // vectors of one head's row
  __shared__ float red[HQ_MAX_THREADS];
  __shared__ float s_skh[HQ_MAX_HEADS], s_rcp[HQ_MAX_HEADS];
  const int nt = blockDim.x, t = threadIdx.x;
  const int H = p.heads, R = p.rows;
  const int v = t % p.cv, r = t / p.cv;
  const bool active = r < R;  // the threads past cv * rows only join the reductions
  const int blk = blockIdx.x, b = blk / p.bps, j = blk % p.bps;
  const int n0 = static_cast<int>((int64_t)j * p.nk / p.bps);
  const int n1 = static_cast<int>((int64_t)(j + 1) * p.nk / p.bps);
  const __nv_bfloat16* kb = p.k + b * p.k_sb + v * 8;
  auto load = [&](int n, uint4 (&raw)[HQ_UNROLL]) {
#pragma unroll
    for (int u = 0; u < HQ_UNROLL; ++u) {
      const int m = n + u * R;
      raw[u] = m < n1 ? __ldg(reinterpret_cast<const uint4*>(kb + (int64_t)m * p.k_sn))
                      : make_uint4(0, 0, 0, 0);
    }
  };

  // the block's |k| amax per head: per thread, then its rows and the CH
  // vectors of each head
  float mx = 0.f;
  for (int n = n0 + r; active && n < n1; n += HQ_UNROLL * R) {
    uint4 raw[HQ_UNROLL];
    load(n, raw);
#pragma unroll
    for (int u = 0; u < HQ_UNROLL; ++u) {
      float x[8];
      Vec<__nv_bfloat16>::unpack(raw[u], x);  // zero-filled past the rows: |0| changes no max
      mx = fmaxf(mx, abs_max8(x));
    }
  }
  red[t] = mx;
  __syncthreads();
  for (int h = t; h < H; h += nt) {
    float m = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      for (int c = 0; c < CH; ++c) m = fmaxf(m, red[rr * p.cv + h * CH + c]);
    }
    p.ws[(int64_t)blk * H + h] = m;
  }
  cooperative_groups::this_grid().sync();

  // the sample's amax per head over its blocks, nl lanes a head (thread
  // (l, h) takes blocks l, l + nl, ...; neighbouring threads read
  // neighbouring slots), then the lanes; the scale by IEEE division
  const int nl = max(1, nt / H);
  for (int i = t; i < nl * H; i += nt) {
    const int h = i % H, l = i / H;
    float m = 0.f;
    for (int j0 = l; j0 < p.bps; j0 += HQ_MERGE_LOADS * nl) {  // loads issued together
      float q[HQ_MERGE_LOADS];
#pragma unroll
      for (int u = 0; u < HQ_MERGE_LOADS; ++u) {
        const int jj = j0 + u * nl;
        q[u] = jj < p.bps ? p.ws[((int64_t)b * p.bps + jj) * H + h] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < HQ_MERGE_LOADS; ++u) m = fmaxf(m, q[u]);
    }
    red[i] = m;
  }
  __syncthreads();
  for (int h = t; h < H; h += nt) {
    float m = 0.f;
    for (int l = 0; l < nl; ++l) m = fmaxf(m, red[l * H + h]);
    const float s = fmaxf(__fdiv_rn(m, 127.f), 1e-8f);
    s_skh[h] = s;
    s_rcp[h] = __frcp_rn(s);
    if (j == 0) p.sk[b * H + h] = s;
  }
  __syncthreads();

  // the codes of the block's rows, 8 bytes a thread and row
  const float s = s_skh[v / CH], rcp = s_rcp[v / CH];
  const int64_t row = (int64_t)H * p.code_d;  // bytes of a key row's codes
  int8_t* out = p.codes + b * p.nk * row + (v / CH) * p.code_d + (v % CH) * 8;
  for (int n = n0 + r; active && n < n1; n += HQ_UNROLL * R) {
    uint4 raw[HQ_UNROLL];
    load(n, raw);
#pragma unroll
    for (int u = 0; u < HQ_UNROLL; ++u) {
      const int m = n + u * R;
      if (m < n1) {
        float x[8];
        Vec<__nv_bfloat16>::unpack(raw[u], x);
        uint2 w;
        w.x = code8r(x[0], s, rcp) | (code8r(x[1], s, rcp) << 8) | (code8r(x[2], s, rcp) << 16) |
              (code8r(x[3], s, rcp) << 24);
        w.y = code8r(x[4], s, rcp) | (code8r(x[5], s, rcp) << 8) | (code8r(x[6], s, rcp) << 16) |
              (code8r(x[7], s, rcp) << 24);
        *reinterpret_cast<uint2*>(out + m * row) = w;
      }
    }
  }
}

// The lab's per-row mode: the codes of 8 values a thread, written
// contiguous (B, Nk, H*D), and the row's scale, the amax of its D values
// over the D/8 lanes that hold them, into sk (B, H) rows of Nk scales
// `sk_pitch` floats apart (Nk for the parent; the sm90 kernel's map takes a
// pitch of whole 16 bytes).
template <int D>
__global__ void __launch_bounds__(QK_THREADS) k_row_codes_kernel(const __nv_bfloat16* k,
                                                                 int64_t k_sb, int64_t k_sn,
                                                                 int batch, int heads, int nk,
                                                                 int64_t sk_pitch, float* sk,
                                                                 int8_t* codes) {
  constexpr int CH = D / 8;  // lanes of one head's row; divides 32
  const int64_t row_ch = (int64_t)heads * CH;
  const int64_t total = (int64_t)batch * nk * row_ch;
  const int64_t i = (int64_t)blockIdx.x * QK_THREADS + threadIdx.x;
  const bool live = i < total;  // whole warps stay on for the shuffles
  const int64_t ii = live ? i : 0;
  const int b = static_cast<int>(ii / (nk * row_ch));
  const int64_t rem = ii - (int64_t)b * nk * row_ch;
  const int n = static_cast<int>(rem / row_ch);
  const int c = static_cast<int>(rem - (int64_t)n * row_ch);
  const int h = c / CH;
  float x[8];
  load8(x, k + b * k_sb + (int64_t)n * k_sn + c * 8);
  float mx = abs_max8(x);
#pragma unroll
  for (int off = CH / 2; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  const float s = fmaxf(__fdiv_rn(mx, 127.f), 1e-8f);
  if (live && c % CH == 0) sk[((int64_t)b * heads + h) * sk_pitch + n] = s;
  if (!live) return;
  uint2 out;
  out.x = code8(x[0], s) | (code8(x[1], s) << 8) | (code8(x[2], s) << 16) | (code8(x[3], s) << 24);
  out.y = code8(x[4], s) | (code8(x[5], s) << 8) | (code8(x[6], s) << 16) | (code8(x[7], s) << 24);
  *reinterpret_cast<uint2*>(codes + i * 8) = out;
}

// ---- launches --------------------------------------------------------------

template <int D, int BQ, bool ROWK>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = Layout<D, BQ, ROWK>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(int8_attn_kernel<D, BQ, ROWK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nq + BQ - 1) / BQ, batch * p.heads);
  int8_attn_kernel<D, BQ, ROWK><<<grid, BQ * 2, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ, bool ROWK>
int launch_d(const Params& p, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch<32, BQ, ROWK>(p, batch, s);
    case 64: return launch<64, BQ, ROWK>(p, batch, s);
    case 128: return launch<128, BQ, ROWK>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

void* head_quant_kernel(int d) {
  switch (d) {
    case 32: return reinterpret_cast<void*>(k_head_quant_kernel<32>);
    case 40: return reinterpret_cast<void*>(k_head_quant_kernel<40>);
    case 64: return reinterpret_cast<void*>(k_head_quant_kernel<64>);
    case 80: return reinterpret_cast<void*>(k_head_quant_kernel<80>);
    case 128: return reinterpret_cast<void*>(k_head_quant_kernel<128>);
    default: return nullptr;
  }
}

template <int D>
int quant_k_rows(const __nv_bfloat16* k, int64_t k_sb, int64_t k_sn, int batch, int heads,
                 int nk, int64_t sk_pitch, float* sk, int8_t* codes, cudaStream_t s) {
  const int64_t chunks = (int64_t)batch * nk * heads * (D / 8);
  const unsigned blocks = static_cast<unsigned>((chunks + QK_THREADS - 1) / QK_THREADS);
  k_row_codes_kernel<D><<<blocks, QK_THREADS, 0, s>>>(k, k_sb, k_sn, batch, heads, nk, sk_pitch,
                                                      sk, codes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of `threads` threads that one SM holds at once for K9p at head
// dimension d; negative: a CUDA error.
extern "C" int pd_int8_quant_k_occupancy(int d, int threads) {
  void* kernel = head_quant_kernel(d);
  if (kernel == nullptr || threads < 1 || threads > HQ_MAX_THREADS) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                                        threads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// K9p on `stream`: returns the launch's cudaError_t (0 = queued). Packed
// bf16 K (B, Nk, H*D) with element strides k_sb, k_sn and 16-byte aligned
// rows -> int8 codes, heads `code_d` bytes apart (B, Nk, H, code_d; code_d
// = D: contiguous (B, Nk, H*D); above D a multiple of 8, its bytes past D
// unwritten), and fp32 scales (B, H); ws:
// batch * bps * heads floats. The plan (key rows in flight, threads per
// block, blocks per sample) comes from `quant_k_plan`; its grid of batch *
// bps blocks must be resident at once (the cooperative launch refuses it
// otherwise).
extern "C" int pd_int8_quant_k_head(const void* k, int64_t k_sb, int64_t k_sn, int batch,
                                    int heads, int nk, int d, int rows, int threads, int bps,
                                    void* ws, void* sk, void* codes, int code_d, void* stream) {
  void* kernel = head_quant_kernel(d);
  const int cv = d > 0 ? heads * d / 8 : 0;
  if (kernel == nullptr || code_d < d || code_d % 8 != 0 || nk <= 0 || batch <= 0 ||
      heads <= 0 || heads > HQ_MAX_HEADS ||
      rows < 1 || threads < cv * rows || threads % 32 != 0 || threads > HQ_MAX_THREADS ||
      bps < 1 || bps > nk || (int64_t)batch * bps > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HeadQuantParams p;
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.k_sb = k_sb;
  p.k_sn = k_sn;
  p.heads = heads;
  p.nk = nk;
  p.cv = cv;
  p.rows = rows;
  p.bps = bps;
  p.ws = static_cast<float*>(ws);
  p.sk = static_cast<float*>(sk);
  p.codes = static_cast<int8_t*>(codes);
  p.code_d = code_d;
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(kernel, dim3(batch * bps), dim3(threads),
                                                      args, 0,
                                                      static_cast<cudaStream_t>(stream)));
}

// The lab's per-row K quantization, on `stream`; returns the launch's
// cudaError_t (0 = queued). Packed bf16 K as K9p's -> int8 codes (B, Nk,
// H*D), contiguous, and fp32 scales, (B, H) rows of Nk scales `sk_pitch`
// (at least Nk) floats apart.
extern "C" int pd_int8_quant_k_rows(const void* k, int64_t k_sb, int64_t k_sn, int batch,
                                    int heads, int nk, int d, void* sk, int64_t sk_pitch,
                                    void* codes, void* stream) {
  if (nk <= 0 || batch <= 0 || heads <= 0 || sk_pitch < nk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  auto* skp = static_cast<float*>(sk);
  auto* cp = static_cast<int8_t*>(codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return quant_k_rows<32>(kp, k_sb, k_sn, batch, heads, nk, sk_pitch, skp, cp, s);
    case 64: return quant_k_rows<64>(kp, k_sb, k_sn, batch, heads, nk, sk_pitch, skp, cp, s);
    case 128: return quant_k_rows<128>(kp, k_sb, k_sn, batch, heads, nk, sk_pitch, skp, cp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches K9 on `stream` and returns the launch's cudaError_t (0 =
// queued). Head dims 32, 64 and 128; `block_q` 64 or 128 query rows per
// block; every row 16-byte aligned and scale > 0 (checked by the Python
// wrapper). `k` holds the prologue's codes; `sk` (B, H) per-head K scales,
// or (B, H, Nk) per-row ones when `row_k` is set.
extern "C" int pd_int8_attention_fwd(
    const void* q, const void* k, const void* sk, int row_k, const void* v, void* o,
    int batch, int heads, int nq, int nk, int d,
    int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn,
    int64_t v_sb, int64_t v_sn, int64_t o_sb, int64_t o_sn,
    float scale, int block_q, void* stream) {
  if (nq <= 0 || nk <= 0 || batch <= 0 || heads <= 0 || (int64_t)batch * heads > 65535 ||
      !(scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.sk = static_cast<const float*>(sk);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = q_sb; p.q_sn = q_sn; p.k_sb = k_sb; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sn = v_sn; p.o_sb = o_sb; p.o_sn = o_sn;
  p.heads = heads; p.nq = nq; p.nk = nk;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_q == 128) {
    return row_k ? launch_d<128, true>(p, batch, d, s) : launch_d<128, false>(p, batch, d, s);
  }
  if (block_q == 64) {
    return row_k ? launch_d<64, true>(p, batch, d, s) : launch_d<64, false>(p, batch, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
