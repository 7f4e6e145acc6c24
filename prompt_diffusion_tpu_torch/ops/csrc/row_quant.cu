// Row -> int8 kernels for Hopper (sm_90a): K10, tanh-GELU -> int8, K13,
// AdaLN -> int8, K7, GEGLU -> int8, K6, LayerNorm -> int8, and K11, row ->
// int8; one int8 code per value and one fp32 scale per row. Beside them
// K12, AdaLN in x's dtype (K13's body with a float epilogue,
// `adaln_float_kernel`), and K12's backward (`adaln_bwd_kernel`, below).
//
// Replace the TPU kernels prompt_diffusion_tpu/ops/fused_act.py::
// fused_gelu_quant (_gelu_quant_kernel through _run), the input of the SD3
// MMDiT's `ff_out` and `ff_context_out`, prompt_diffusion_tpu/ops/
// fused_adaln.py::fused_adaln_quant (_adaln_quant_kernel), the four
// modulation sites of every JointBlock in the int8 serving mode, and
// prompt_diffusion_tpu/ops/fused_act.py::fused_geglu_quant
// (_geglu_quant_kernel through _run), the feed-forward of every SD1.5
// transformer block in the int8 serving mode,
// prompt_diffusion_tpu/ops/fused_layer_norm.py::fused_layer_norm_quant
// (_ln_quant_kernel), the pre-LNs of every SD1.5 transformer block and of
// the DPT ViT blocks in the int8 serving mode, and
// prompt_diffusion_tpu/ops/fused_act.py::fused_quant_rows
// (_quant_rows_kernel through _run), the attention outputs of every SD3
// JointBlock in the int8 serving mode; and prompt_diffusion_tpu/ops/
// fused_adaln.py::fused_adaln (_adaln_kernel) with its custom_vjp's _bwd,
// which no model calls (a training step of an AdaLN site would). Per row,
// in fp32:
//
//   K10: y = x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
//   K13: y = (x - mean) * rsqrt(var + eps) * (1 + scale[b]) + shift[b]
//        (LayerNorm without affine, eps 1e-6, per-sample modulation)
//   K7:  a row is [h | gate], 2C values; y = h * gelu_erf(gate) with
//        gelu_erf(g) = g * 0.5 * (1 + erf(g / sqrt 2)), C values
//   K6:  y = (x - mean) * rsqrt(var + eps) * w[c] + b[c] (LayerNorm with
//        the module's per-column affine; the products and the sum rounded
//        one by one, in the plain version's order, not contracted as K13's)
//   K11: y = x
//   K12: K13's y, stored in x's dtype (bf16 rounded to nearest), no codes
//   then s = max(amax|y| / 127, 1e-8) by IEEE division, and the codes
//   rint(y / s) with y / s the IEEE quotient, clipped to +-127
//   (`rowquant`, fused_layer_norm.py:28 of the JAX package).
//
// What bounds them on the H100: bytes, one read of the bf16 row and one
// write of its int8 codes (3 bytes a value; K7 5 bytes an output value):
// 0.045 ms at K10's (8192, 6144), 0.011 ms at K13's (2, 4096, 1536) and
// K11's (8192, 1536), 0.063 ms at K7's (32768, 2560) and 0.0094 ms at K6's
// (32768, 320) at 3.35 TB/s; K12 reads and writes bf16 (4 bytes a
// value): 0.015 ms at (2, 4096, 1536), and its backward reads x and the
// gradient and writes dx: 0.045 ms at (2, 4096, 1536) in fp32 (12 bytes a
// value), 0.023 in bf16. K10's arithmetic comes
// close: at ~33.5e12 thread-instructions/s the byte bound leaves ~27
// instructions a value (K7 ~50 per output value, of which CUDA's erff
// takes the most). So the design keeps every value in registers from the
// load to its code and spends few instructions on each:
//   * no padding of a row to a power of two: a row is cut into 16-byte
//     vectors (8 bf16 or 4 fp32), vector t + k * TPR to thread t of the
//     row's TPR threads (`row_plan` in ops/row_quant.py picks TPR, the
//     vectors per thread VPT and the row groups per block; K7's thread
//     holds vector v of h and vector v of gate, so both count against the
//     8 vectors a thread may hold);
//     K13's rows (C = 1536) take one warp each, so its mean, variance and
//     amax are warp shuffles with no shared memory and no barrier; K10's
//     (C = 6144) take 256 threads, and its one reduction takes one barrier;
//     K7's (C = 1280, 2560, 5120) take 128, 256 and 256 threads; K11's
//     (C = 1536) a warp, as K13's, and K6's C = 1280 and 768 too; K6's
//     narrow rows (C = 320, 640: 40 and 80 vectors) take 8 and 16 aligned
//     lanes of a warp, 5 vectors each, so that no lane idles (a warp would
//     leave 24 of 32 lanes idle in the second vector at C = 320), and
//     their shuffles stay within the row's lanes;
//   * the division once per row: s, then r = 1/s rounded to nearest; each
//     quotient is y * r with one FMA residual and one FMA correction
//     (Markstein), equal to __fdiv_rn(y, s) bit for bit
//     (`tools/quant_tune.py --part check` holds it so on the card over
//     every value of the SD3 cases and every float y in [s/4, 128 s] for
//     128 values of s); rint is the 1.5 * 2^23 shift, whose sum's low byte
//     is the code, and four codes are packed by byte permutes into one
//     32-bit word, stored 8 (bf16) or 4 (fp32) bytes at a time. |y| <= amax
//     and s >= amax / 127 rounded to nearest make |y / s| <= 127 + 2^-16,
//     so for finite inputs the clip can never bind and is not executed;
//   * K10's GELU as x * sigmoid(2z) = x / (1 + 2^(-2 z log2 e)): one ex2 and
//     one reciprocal of the special-function units, a few ulp from the tanh
//     form (whose 1 + tanh cancels for negative x), and 0 where the tanh
//     form's 1 + tanh rounds to 0 (`quant_tune` builds a copy with CUDA's
//     tanhf for its A/B);
//   * K13's modulation is read once per block, straight from the bf16 or
//     fp32 (B, 1, C) or (B, C) views the model passes (batch and column
//     strides): every block serves rows of one sample b and stages
//     1 + scale[b] and shift[b] as fp32 in shared memory (8 C bytes), in
//     the order its threads read them (float4 j of vector v at j * nvec + v,
//     so a warp's loads are conflict-free); K6's affine w and b (the
//     module's (C,) parameters, batch stride 0) likewise;
//   * rows are read in place with the caller's sample and row strides: K11
//     takes the MMDiT's (B, N, C) slices of its packed (B, N_h + N_c, C)
//     attention output, whose sample stride is (N_h + N_c) C, without a
//     copy;
//   * latency: a block walks `groups` row groups of its sample and loads
//     the next group's vectors into registers before it quantizes the
//     current one; `row_plan` takes 4 or 2 groups where the grid keeps ~2
//     blocks per SM, else 1 (several blocks per SM, nothing pipelined):
//     the best of `quant_tune --part time`'s sweep at every SD3 shape.
// Sums are taken in a fixed order (xor-butterfly shuffles give every lane
// the same value; a row's warp partials are added in warp order), so runs
// repeat bit for bit.
//
// K10 and K11 split over a tensor group (`row_split_kernel`, ops 6-9): under
// tensor parallelism a rank holds a slice of each row's columns (its heads,
// its hidden units), and the row's scale spans them all. Pass 1 (ops 6, 7)
// writes each row's amax of GELU(x) (K10) or of x (K11) over the rank's
// columns as one fp32 per row; the wrapper all-reduces it with MAX over the
// group; pass 2 (ops 8, 9) reads x again and writes the codes of the rank's
// columns and the scale s = max(amax / 127, 1e-8), with the one-launch
// kernels' GELU, IEEE division, quotient and rint. Max is exact in any
// order, so over a group of one rank the codes and scales are the
// one-launch kernels' bit for bit. Each pass reads the row once (pass 2
// also writes the int8 codes): bound by bytes as the one-launch kernels
// are, 2 bytes a bf16 value for pass 1 and 3 for pass 2. The passes are
// the simple form, on the same row plan without the next group's loads in
// flight (`row_plan(..., groups=1)`).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "quant_common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                  // threads of every block
constexpr int kMaxVpt = 8;                     // 16-byte vectors a thread holds of a row
constexpr int kRedFloats = 2 * kThreads / kWarp;  // two buffers of one partial per warp
constexpr int kSmemDefault = 48 * 1024;

enum Op {
  kGelu = 0, kAdaLN = 1, kGeglu = 2, kLN = 3, kRows = 4, kAdaLNF = 5,
  // the split K10 / K11: pass 1, the row amax; pass 2, the codes from it
  kGeluAmax = 6, kRowsAmax = 7, kGeluCodes = 8, kRowsCodes = 9
};

struct Params {
  const void* x;
  int64_t x_sb, x_sn;  // element strides of a sample and of a row; columns dense
  int n, c;            // rows per sample, columns
  int tpr, groups;     // threads per row, row groups per block
  const void* sc;      // K13: scale, shift; K6: w, b; each bf16 or fp32, element strides
  int64_t sc_sb, sc_sc;
  const void* sh;
  int64_t sh_sb, sh_sc;
  int sc_bf16, sh_bf16;
  float eps;
  void* out;      // int8 codes, or K12's y in x's dtype: (batch * n, c), dense
  float* scales;  // (batch * n); K12: none; the split's pass 1: the row amax
  const float* amax;  // the split's pass 2: the all-reduced row amax (batch * n)
  int gelu;           // the split passes: K10 (1) or K11 (0)
};

// -2 sqrt(2/pi) log2(e) and 0.044715 times it: x * (C1 + C3 x^2) = -2 z log2(e)
constexpr float kGeluC1 = static_cast<float>(-2.0 * 0.7978845608028654 * 1.4426950408889634);
constexpr float kGeluC3 = static_cast<float>(-2.0 * 0.7978845608028654 * 1.4426950408889634 *
                                             0.044715);

__device__ __forceinline__ float gelu(float x) {
  const float u = x * fmaf(kGeluC3, x * x, kGeluC1);
  float e, rcp;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(u));
  const float d = 1.0f + e;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rcp) : "f"(d));
  // where exp(-2z) > 2^24, 1 + tanh z rounds to 0 in fp32: the tanh form's
  // GELU is 0 there, and so is this one (no tiny values whose quotient's
  // residual would underflow)
  return __fmul_rn(x, e > 16777216.0f ? 0.0f : rcp);
}

// K7: h * gelu_erf(g) in the plain version's order (PyTorch's CUDA GELU is
// x * 0.5 * (1 + erf(x * M_SQRT1_2)) with CUDA's erff), so that y is the
// plain version's fp32 value
__device__ __forceinline__ float geglu(float h, float g) {
  return __fmul_rn(h, __fmul_rn(__fmul_rn(g, 0.5f),
                                __fadd_rn(1.0f, erff(__fmul_rn(g, 0.7071067811865476f)))));
}

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

// The reduction over one row's threads: xor-butterfly shuffles (every lane
// ends with the same value; a row of tpr < 32 threads, tpr aligned lanes,
// takes only the offsets below tpr); for a row of several warps, one partial per
// warp through shared memory, added in warp order. `red` alternates between
// two buffers, so one barrier per reduction suffices: a warp writes buffer
// k % 2 again only after the barrier of reduction k + 1, which every thread
// reaches after its reads of reduction k.
template <bool kMax>
__device__ __forceinline__ float row_reduce(float v, int tpr, float* red, int& slot) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    if (off < tpr) v = combine<kMax>(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if (tpr <= kWarp) return v;
  float* buf = red + slot * (kThreads / kWarp);
  slot ^= 1;
  if ((threadIdx.x & (kWarp - 1)) == 0) buf[threadIdx.x / kWarp] = v;
  __syncthreads();
  const int wpr = tpr / kWarp;
  const float* row = buf + (threadIdx.x / tpr) * wpr;
  float r = row[0];
  for (int w = 1; w < wpr; ++w) r = combine<kMax>(r, row[w]);
  return r;
}

__device__ __forceinline__ float load_mod(const void* p, int is_bf16, int64_t i) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// One block: rows [row0, row0 + groups * rpb) of sample blockIdx.y, rpb =
// kThreads / tpr rows at a time (a group), thread t of a row holding
// vectors t + k * tpr, k < VPT (those < nvec) of each of the row's NIN
// inputs (K7: h, then gate at vector nvec + v). PIPE: the next group's
// vectors are loaded before the current group is reduced and quantized.
template <typename T, int VPT, int OP, bool PIPE>
__device__ __forceinline__ void row_quant_body(const Params& p) {
  constexpr int E = Vec<T>::E;
  constexpr int NIN = OP == kGeglu ? 2 : 1;
  constexpr bool kModulated = OP == kAdaLN || OP == kAdaLNF;
  constexpr bool kFloatOut = OP == kAdaLNF;  // K12: y in x's dtype, no codes
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);  // kRedFloats, then K13's or K6's 2 C floats
  float* mod = red + kRedFloats;
  const int tpr = p.tpr;
  const int rpb = kThreads / tpr;
  const int t = threadIdx.x % tpr;
  const int slot_row = threadIdx.x / tpr;
  const int nvec = p.c / E;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rpb * p.groups;
  const T* xb = static_cast<const T*>(p.x) + b * p.x_sb;

  auto load = [&](int g, uint4 (&dst)[NIN * VPT]) {
    const int n_idx = row0 + g * rpb + slot_row;
    const uint4* xr = reinterpret_cast<const uint4*>(xb + (int64_t)n_idx * p.x_sn);
#pragma unroll
    for (int i = 0; i < NIN; ++i) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int v = t + k * tpr;
        dst[i * VPT + k] = (n_idx < p.n && v < nvec) ? __ldg(xr + i * nvec + v)
                                                     : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  uint4 raw[NIN * VPT];
  load(0, raw);

  if constexpr (kModulated || OP == kLN) {
    for (int col = threadIdx.x; col < p.c; col += kThreads) {
      const int v = col / E, j = col % E;
      const int idx = ((j >> 2) * nvec + v) * 4 + (j & 3);
      const float m1 = load_mod(p.sc, p.sc_bf16, b * p.sc_sb + col * p.sc_sc);
      mod[idx] = kModulated ? 1.0f + m1 : m1;
      mod[p.c + idx] = load_mod(p.sh, p.sh_bf16, b * p.sh_sb + col * p.sh_sc);
    }
    __syncthreads();
  }

  int slot = 0;
  for (int g = 0; g < p.groups; ++g) {
    uint4 next[NIN * VPT];
    if constexpr (PIPE) {
      if (g + 1 < p.groups) load(g + 1, next);
    }
    const int n_idx = row0 + g * rpb + slot_row;
    float v[VPT][E];
#pragma unroll
    for (int k = 0; k < VPT; ++k) Vec<T>::unpack(raw[k], v[k]);  // zeros past the row

    float amax = 0.f;
    if constexpr (OP == kGeglu) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        float gate[E];
        Vec<T>::unpack(raw[VPT + k], gate);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          v[k][j] = geglu(v[k][j], gate[j]);  // 0 past the row
          amax = fmaxf(amax, fabsf(v[k][j]));
        }
      }
    } else if constexpr (OP == kGelu) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          v[k][j] = gelu(v[k][j]);  // gelu(0) = 0 past the row
          amax = fmaxf(amax, fabsf(v[k][j]));
        }
      }
    } else if constexpr (OP == kRows) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
#pragma unroll
        for (int j = 0; j < E; ++j) amax = fmaxf(amax, fabsf(v[k][j]));  // 0 past the row
      }
    } else {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
#pragma unroll
        for (int j = 0; j < E; ++j) sum += v[k][j];
      }
      const float mean = __fdiv_rn(row_reduce<false>(sum, tpr, red, slot),
                                   static_cast<float>(p.c));
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        if (t + k * tpr < nvec) {
#pragma unroll
          for (int j = 0; j < E; ++j) {
            v[k][j] -= mean;
            sq = fmaf(v[k][j], v[k][j], sq);
          }
        }
      }
      const float var = __fdiv_rn(row_reduce<false>(sq, tpr, red, slot), static_cast<float>(p.c));
      const float rstd = rsqrtf(var + p.eps);
      const float4* sc4 = reinterpret_cast<const float4*>(mod);
      const float4* sh4 = reinterpret_cast<const float4*>(mod + p.c);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int vi = t + k * tpr;
        if (vi < nvec) {
#pragma unroll
          for (int h = 0; h < E / 4; ++h) {
            const float4 s1 = sc4[h * nvec + vi], s0 = sh4[h * nvec + vi];
            const float m1[4] = {s1.x, s1.y, s1.z, s1.w}, m0[4] = {s0.x, s0.y, s0.z, s0.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float& y = v[k][4 * h + j];
              if constexpr (kModulated) {  // contracted: one rounding of y * rstd, one FMA
                y = fmaf(y * rstd, m1[j], m0[j]);
              } else {  // K6: (y * rstd) * w + b, each step rounded
                y = __fadd_rn(__fmul_rn(__fmul_rn(y, rstd), m1[j]), m0[j]);
              }
              if constexpr (!kFloatOut) amax = fmaxf(amax, fabsf(y));
            }
          }
        }
      }
    }
    if constexpr (kFloatOut) {  // K12: 16-byte stores of y in x's dtype
      if (n_idx < p.n) {
        T* out = static_cast<T*>(p.out) + ((int64_t)b * p.n + n_idx) * p.c;
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
          const int vi = t + k * tpr;
          if (vi < nvec) *reinterpret_cast<uint4*>(out + (int64_t)vi * E) = Vec<T>::pack(v[k]);
        }
      }
    } else {
      amax = row_reduce<true>(amax, tpr, red, slot);
      const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
      const float r = __frcp_rn(s);
      if (n_idx < p.n) {
        const int64_t row = (int64_t)b * p.n + n_idx;
        int8_t* out = static_cast<int8_t*>(p.out) + row * p.c;
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
          const int vi = t + k * tpr;
          if (vi < nvec) {
            uint32_t w[E / 4];
#pragma unroll
            for (int h = 0; h < E / 4; ++h) {
              const float* y = v[k] + 4 * h;
              w[h] = rq::pack4(rq::code_bits(rq::quotient(y[0], s, r)),
                               rq::code_bits(rq::quotient(y[1], s, r)),
                               rq::code_bits(rq::quotient(y[2], s, r)),
                               rq::code_bits(rq::quotient(y[3], s, r)));
            }
            if constexpr (E == 8) {
              *reinterpret_cast<uint2*>(out + (int64_t)vi * E) = make_uint2(w[0], w[1]);
            } else {
              *reinterpret_cast<uint32_t*>(out + (int64_t)vi * E) = w[0];
            }
          }
        }
        if (t == 0) p.scales[row] = s;
      }
    }
    if constexpr (PIPE) {
#pragma unroll
      for (int k = 0; k < NIN * VPT; ++k) raw[k] = next[k];
    }
  }
}

template <typename T, int VPT, bool PIPE>
__global__ void __launch_bounds__(kThreads) gelu_quant_kernel(const Params p) {
  row_quant_body<T, VPT, kGelu, PIPE>(p);
}

template <typename T, int VPT, bool PIPE>
__global__ void __launch_bounds__(kThreads) adaln_quant_kernel(const Params p) {
  row_quant_body<T, VPT, kAdaLN, PIPE>(p);
}

template <typename T, int VPT, bool PIPE>
__global__ void __launch_bounds__(kThreads) geglu_quant_kernel(const Params p) {
  row_quant_body<T, VPT, kGeglu, PIPE>(p);
}

template <typename T, int VPT, bool PIPE>
__global__ void __launch_bounds__(kThreads) ln_quant_kernel(const Params p) {
  row_quant_body<T, VPT, kLN, PIPE>(p);
}

template <typename T, int VPT, bool PIPE>
__global__ void __launch_bounds__(kThreads) rows_quant_kernel(const Params p) {
  row_quant_body<T, VPT, kRows, PIPE>(p);
}

template <typename T, int VPT, bool PIPE>
__global__ void __launch_bounds__(kThreads) adaln_float_kernel(const Params p) {
  row_quant_body<T, VPT, kAdaLNF, PIPE>(p);
}

// The split K10 / K11, pass 1 (kCodes false: each row's amax of y, y =
// GELU(x) or x, over its columns here, to p.scales) or pass 2 (kCodes true:
// the codes of y and s = max(p.amax[row] / 127, 1e-8) to p.scales). One
// block: rows [row0, row0 + groups * rpb) of sample blockIdx.y, the row
// plan of `row_quant_body`, one group after the other.
template <typename T, int VPT, bool kCodes>
__global__ void __launch_bounds__(kThreads) row_split_kernel(const Params p) {
  constexpr int E = Vec<T>::E;
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  const int tpr = p.tpr;
  const int rpb = kThreads / tpr;
  const int t = threadIdx.x % tpr;
  const int slot_row = threadIdx.x / tpr;
  const int nvec = p.c / E;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rpb * p.groups;
  const T* xb = static_cast<const T*>(p.x) + b * p.x_sb;
  int slot = 0;
  for (int g = 0; g < p.groups; ++g) {
    const int n_idx = row0 + g * rpb + slot_row;
    const bool live = n_idx < p.n;
    const uint4* xr = reinterpret_cast<const uint4*>(xb + (int64_t)n_idx * p.x_sn);
    float v[VPT][E];
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int vi = t + k * tpr;
      Vec<T>::unpack(live && vi < nvec ? __ldg(xr + vi) : make_uint4(0u, 0u, 0u, 0u), v[k]);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (p.gelu) v[k][j] = gelu(v[k][j]);  // gelu(0) = 0 past the row
        amax = fmaxf(amax, fabsf(v[k][j]));
      }
    }
    const int64_t row = (int64_t)b * p.n + n_idx;
    if constexpr (!kCodes) {
      amax = row_reduce<true>(amax, tpr, red, slot);  // every thread of the block
      if (live && t == 0) p.scales[row] = amax;
    } else if (live) {
      const float s = fmaxf(__fdiv_rn(p.amax[row], 127.f), 1e-8f);
      const float r = __frcp_rn(s);
      int8_t* out = static_cast<int8_t*>(p.out) + row * p.c;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int vi = t + k * tpr;
        if (vi < nvec) {
          uint32_t w[E / 4];
#pragma unroll
          for (int h = 0; h < E / 4; ++h) {
            const float* y = v[k] + 4 * h;
            w[h] = rq::pack4(rq::code_bits(rq::quotient(y[0], s, r)),
                             rq::code_bits(rq::quotient(y[1], s, r)),
                             rq::code_bits(rq::quotient(y[2], s, r)),
                             rq::code_bits(rq::quotient(y[3], s, r)));
          }
          if constexpr (E == 8) {
            *reinterpret_cast<uint2*>(out + (int64_t)vi * E) = make_uint2(w[0], w[1]);
          } else {
            *reinterpret_cast<uint32_t*>(out + (int64_t)vi * E) = w[0];
          }
        }
      }
      if (t == 0) p.scales[row] = s;
    }
  }
}

template <typename T, int VPT>
int launch_split(int op, const Params& p, dim3 grid, cudaStream_t s) {
  const size_t smem = sizeof(float) * kRedFloats;
  if (op == kGeluAmax || op == kRowsAmax) {
    row_split_kernel<T, VPT, false><<<grid, kThreads, smem, s>>>(p);
  } else {
    row_split_kernel<T, VPT, true><<<grid, kThreads, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_split_vpt(int vpt, int op, const Params& p, dim3 grid, cudaStream_t s) {
  switch (vpt) {
    case 1: return launch_split<T, 1>(op, p, grid, s);
    case 2: return launch_split<T, 2>(op, p, grid, s);
    case 3: return launch_split<T, 3>(op, p, grid, s);
    case 4: return launch_split<T, 4>(op, p, grid, s);
    case 5: return launch_split<T, 5>(op, p, grid, s);
    case 6: return launch_split<T, 6>(op, p, grid, s);
    case 7: return launch_split<T, 7>(op, p, grid, s);
    case 8: return launch_split<T, 8>(op, p, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int VPT, bool PIPE>
int launch(int op, const Params& p, dim3 grid, cudaStream_t s) {
  // K13's and K12's modulation or K6's affine: 2 C floats after the
  // reduction buffers
  const bool staged = op == kAdaLN || op == kLN || op == kAdaLNF;
  const size_t smem = sizeof(float) * (kRedFloats + (staged ? 2 * (size_t)p.c : 0));
  void (*kernel)(const Params) = nullptr;
  if (op == kGelu) {
    kernel = gelu_quant_kernel<T, VPT, PIPE>;
  } else if (op == kAdaLN) {
    kernel = adaln_quant_kernel<T, VPT, PIPE>;
  } else if (op == kLN) {
    kernel = ln_quant_kernel<T, VPT, PIPE>;
  } else if (op == kRows) {
    kernel = rows_quant_kernel<T, VPT, PIPE>;
  } else if (op == kAdaLNF) {
    kernel = adaln_float_kernel<T, VPT, PIPE>;
  } else if constexpr (2 * VPT <= kMaxVpt) {  // K7 holds VPT vectors of h and of gate
    kernel = geglu_quant_kernel<T, VPT, PIPE>;
  }
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PIPE>
int launch_vpt(int vpt, int op, const Params& p, dim3 grid, cudaStream_t s) {
  switch (vpt) {
    case 1: return launch<T, 1, PIPE>(op, p, grid, s);
    case 2: return launch<T, 2, PIPE>(op, p, grid, s);
    case 3: return launch<T, 3, PIPE>(op, p, grid, s);
    case 4: return launch<T, 4, PIPE>(op, p, grid, s);
    case 5: return launch<T, 5, PIPE>(op, p, grid, s);
    case 6: return launch<T, 6, PIPE>(op, p, grid, s);
    case 7: return launch<T, 7, PIPE>(op, p, grid, s);
    case 8: return launch<T, 8, PIPE>(op, p, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- K12's backward: adaln_bwd_kernel ---------------------------------

struct BwdParams {
  const void* x;
  int64_t x_sb, x_sn;  // element strides of a sample and of a row; columns dense
  const void* g;       // the output's gradient, x's dtype
  int64_t g_sb, g_sn;
  int n, c;
  int tpr, groups, bps, merge_lanes;  // the plan: blocks per sample bps = gridDim.x
  const void* sc;                     // scale, bf16 or fp32, element strides
  int64_t sc_sb, sc_sc;
  int sc_bf16;
  float eps;
  void* dx;        // (batch, n, c), dense, x's dtype
  void* dscale;    // (batch, c), dense, bf16 or fp32
  void* dshift;
  int dscale_bf16, dshift_bf16;
  float* ws;       // (batch, bps, 2 c): each block's column sums of g, then of g * xhat
};

constexpr int kMergeLoads = 4;  // partials a merge lane has in flight

__device__ __forceinline__ void store_float(void* base, int bf16, int64_t i, float v) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(base)[i] = v;
  }
}

// Shared memory: the reduction buffers, 1 + scale[b] (C floats, in the
// forward's float4 order), then the block's column sums (2 C floats, at
// least kThreads: the merge's partial sums reuse them); 196 KB at the
// widest row, C = 16384, within a block's 227 KB.
__host__ __device__ constexpr size_t bwd_smem_floats(int c) {
  return kRedFloats + c + (2 * c > kThreads ? 2 * c : kThreads);
}

// One cooperative launch of a grid of bps x batch blocks, all resident:
//   phase 1, the rows: block (j, b) walks `groups` row groups of sample b
//   on K13's row plan (a row's threads hold the same columns in every
//   row); per row it reloads x and g, takes mean and rstd by the row's
//   reductions (nothing is saved from the forward: x is read anyway), then
//   ghat = g * (1 + scale[b]), xhat = (x - mean) * rstd and the row means
//   of ghat and ghat * xhat (two more reductions), and writes
//   dx = rstd * (ghat - mean(ghat) - xhat * mean(ghat * xhat)) in x's
//   dtype. Each thread keeps the running column sums of g and g * xhat of
//   its columns in registers; at the end the block adds them over its row
//   slots in slot order in shared memory and writes one (2, C) fp32
//   partial to the workspace;
//   grid barrier;
//   phase 2, the merge: block j of sample b takes a contiguous slice of the
//   sample's 2 C sums; for each, `merge_lanes` lanes sum the sample's
//   partials j', j' + lanes, ... in order, and the lanes' sums are added
//   in lane order; then dshift = sum g and dscale = sum g * xhat in their
//   dtypes. Every sum is taken in an order fixed by the plan, so a call
//   repeats bit for bit (atomics would not).
// What bounds it: bytes (x and g read once, dx written once: 0.045 ms in
// fp32 at (2, 4096, 1536)), and registers: a thread holds its vectors of x
// and of g, the next row group's (loaded before the current group's four
// reductions) and two fp32 sums per column. At most BWD_VECTORS = 3
// vectors of each a thread (`adaln_bwd_plan`): 64 threads a bf16 row of
// 1536 (48 sums a thread), 128 an fp32 one, in 128 registers at two
// blocks of 256 threads per SM; a warp per bf16 row would hold 96 sums
// and spill (`quant_tune --part sass`).
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads, 2) adaln_bwd_kernel(const BwdParams p) {
  constexpr int E = Vec<T>::E;
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  float* mod = red + kRedFloats;
  float* cols = mod + p.c;
  const int tpr = p.tpr;
  const int rpb = kThreads / tpr;
  const int t = threadIdx.x % tpr;
  const int slot_row = threadIdx.x / tpr;
  const int nvec = p.c / E;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rpb * p.groups;
  const T* xb = static_cast<const T*>(p.x) + b * p.x_sb;
  const T* gb = static_cast<const T*>(p.g) + b * p.g_sb;

  // vectors k < VPT of x, then of g, of the row slot's row in group grp
  auto load = [&](int grp, uint4 (&dst)[2 * VPT]) {
    const int n_idx = row0 + grp * rpb + slot_row;
    const uint4* xr = reinterpret_cast<const uint4*>(xb + (int64_t)n_idx * p.x_sn);
    const uint4* gr = reinterpret_cast<const uint4*>(gb + (int64_t)n_idx * p.g_sn);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = t + k * tpr;
      const bool in = n_idx < p.n && v < nvec;
      dst[k] = in ? __ldg(xr + v) : make_uint4(0u, 0u, 0u, 0u);
      dst[VPT + k] = in ? __ldg(gr + v) : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  uint4 raw[2 * VPT];
  load(0, raw);
  for (int col = threadIdx.x; col < p.c; col += kThreads) {
    const int v = col / E, j = col % E;
    mod[((j >> 2) * nvec + v) * 4 + (j & 3)] =
        1.0f + load_mod(p.sc, p.sc_bf16, b * p.sc_sb + col * p.sc_sc);
  }
  __syncthreads();
  const float4* sc4 = reinterpret_cast<const float4*>(mod);

  float acc_g[VPT][E], acc_gx[VPT][E];  // the thread's column sums
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
#pragma unroll
    for (int j = 0; j < E; ++j) acc_g[k][j] = acc_gx[k][j] = 0.f;
  }

  int slot = 0;
  for (int grp = 0; grp < p.groups; ++grp) {
    uint4 next[2 * VPT];  // the next group's, loaded before this one's reductions
    if (grp + 1 < p.groups) load(grp + 1, next);
    const int n_idx = row0 + grp * rpb + slot_row;
    float v[VPT][E];  // x, then x - mean, then xhat; zeros past the row
#pragma unroll
    for (int k = 0; k < VPT; ++k) Vec<T>::unpack(raw[k], v[k]);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
#pragma unroll
      for (int j = 0; j < E; ++j) sum += v[k][j];
    }
    const float mean = __fdiv_rn(row_reduce<false>(sum, tpr, red, slot), static_cast<float>(p.c));
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (t + k * tpr < nvec) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          v[k][j] -= mean;
          sq = fmaf(v[k][j], v[k][j], sq);
        }
      }
    }
    const float var = __fdiv_rn(row_reduce<false>(sq, tpr, red, slot), static_cast<float>(p.c));
    const float rstd = rsqrtf(var + p.eps);
    float sg = 0.f, sgx = 0.f;  // the row's sums of ghat and ghat * xhat
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int vi = t + k * tpr;
      if (vi < nvec) {
        float gv[E];
        Vec<T>::unpack(raw[VPT + k], gv);
#pragma unroll
        for (int h = 0; h < E / 4; ++h) {
          const float4 s1 = sc4[h * nvec + vi];
          const float m1[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 4 * h + i;
            const float xh = v[k][j] * rstd;
            const float gh = gv[j] * m1[i];
            v[k][j] = xh;
            sg += gh;
            sgx = fmaf(gh, xh, sgx);
            acc_g[k][j] += gv[j];
            acc_gx[k][j] = fmaf(gv[j], xh, acc_gx[k][j]);
          }
        }
      }
    }
    const float mg = __fdiv_rn(row_reduce<false>(sg, tpr, red, slot), static_cast<float>(p.c));
    const float mgx = __fdiv_rn(row_reduce<false>(sgx, tpr, red, slot), static_cast<float>(p.c));
    if (n_idx < p.n) {
      T* dx = static_cast<T*>(p.dx) + ((int64_t)b * p.n + n_idx) * p.c;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int vi = t + k * tpr;
        if (vi < nvec) {
          float gv[E], d[E];
          Vec<T>::unpack(raw[VPT + k], gv);
#pragma unroll
          for (int h = 0; h < E / 4; ++h) {
            const float4 s1 = sc4[h * nvec + vi];
            const float m1[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 4 * h + i;
              d[j] = rstd * fmaf(-v[k][j], mgx, gv[j] * m1[i] - mg);
            }
          }
          *reinterpret_cast<uint4*>(dx + (int64_t)vi * E) = Vec<T>::pack(d);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2 * VPT; ++k) raw[k] = next[k];
  }

  // the block's column sums: row slots added in slot order
  float4* cols4 = reinterpret_cast<float4*>(cols);
  for (int s = 0; s < rpb; ++s) {
    if (slot_row == s) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int vi = t + k * tpr;
        if (vi < nvec) {
#pragma unroll
          for (int h = 0; h < E / 4; ++h) {
            const int q4 = vi * (E / 4) + h;
            const float* a = acc_g[k] + 4 * h;
            const float* ax = acc_gx[k] + 4 * h;
            float4 cg4 = make_float4(a[0], a[1], a[2], a[3]);
            float4 cx4 = make_float4(ax[0], ax[1], ax[2], ax[3]);
            if (s > 0) {
              const float4 o = cols4[q4], ox = cols4[p.c / 4 + q4];
              cg4 = make_float4(o.x + cg4.x, o.y + cg4.y, o.z + cg4.z, o.w + cg4.w);
              cx4 = make_float4(ox.x + cx4.x, ox.y + cx4.y, ox.z + cx4.z, ox.w + cx4.w);
            }
            cols4[q4] = cg4;
            cols4[p.c / 4 + q4] = cx4;
          }
        }
      }
    }
    __syncthreads();
  }
  const int two_c = 2 * p.c;
  float4* part = reinterpret_cast<float4*>(p.ws + ((int64_t)b * p.bps + blockIdx.x) * two_c);
  for (int q4 = threadIdx.x; q4 < two_c / 4; q4 += kThreads) part[q4] = cols4[q4];

  cooperative_groups::this_grid().sync();

  // phase 2: sums [q0, q1) of sample b, `lanes` lanes each
  const int lanes = p.merge_lanes, width = kThreads / lanes;
  const int lane = threadIdx.x / width, qi = threadIdx.x % width;
  const int per_block = (two_c + p.bps - 1) / p.bps;
  const int q0 = blockIdx.x * per_block, q1 = min(q0 + per_block, two_c);
  const float* parts = p.ws + (int64_t)b * p.bps * two_c;
  for (int qb = q0; qb < q1; qb += width) {  // the same trip count in every thread
    const int q = qb + qi;
    float acc = 0.f;
    if (q < q1) {
      for (int j0 = lane; j0 < p.bps; j0 += kMergeLoads * lanes) {
        float w[kMergeLoads];
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          const int jj = min(j0 + u * lanes, p.bps - 1);
          w[u] = parts[(int64_t)jj * two_c + q];
        }
#pragma unroll
        for (int u = 0; u < kMergeLoads; ++u) {
          if (j0 + u * lanes < p.bps) acc += w[u];
        }
      }
    }
    cols[lane * width + qi] = acc;
    __syncthreads();
    if (lane == 0 && q < q1) {
      float total = cols[qi];
      for (int l = 1; l < lanes; ++l) total += cols[l * width + qi];
      if (q < p.c) {
        store_float(p.dshift, p.dshift_bf16, (int64_t)b * p.c + q, total);
      } else {
        store_float(p.dscale, p.dscale_bf16, (int64_t)b * p.c + q - p.c, total);
      }
    }
    __syncthreads();
  }
}

template <typename T>
void* bwd_kernel_of(int vpt) {
  switch (vpt) {
    case 1: return reinterpret_cast<void*>(adaln_bwd_kernel<T, 1>);
    case 2: return reinterpret_cast<void*>(adaln_bwd_kernel<T, 2>);
    case 3: return reinterpret_cast<void*>(adaln_bwd_kernel<T, 3>);
    case 4: return reinterpret_cast<void*>(adaln_bwd_kernel<T, 4>);
    case 5: return reinterpret_cast<void*>(adaln_bwd_kernel<T, 5>);
    case 6: return reinterpret_cast<void*>(adaln_bwd_kernel<T, 6>);
    case 7: return reinterpret_cast<void*>(adaln_bwd_kernel<T, 7>);
    case 8: return reinterpret_cast<void*>(adaln_bwd_kernel<T, 8>);
    default: return nullptr;
  }
}

// K12's backward <bf16 or fp32, vpt>, with its shared memory for c columns
// allowed, or nullptr
void* pick_bwd(int x_bf16, int vpt, int c) {
  void* kernel = x_bf16 ? bwd_kernel_of<__nv_bfloat16>(vpt) : bwd_kernel_of<float>(vpt);
  const size_t smem = sizeof(float) * bwd_smem_floats(c);
  if (kernel != nullptr && smem > kSmemDefault &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return nullptr;
  }
  return kernel;
}

}  // namespace

// K10 (op 0), K13 (op 1), K7 (op 2), K6 (op 3), K11 (op 4) or K12 (op 5) on
// `stream`, or a pass of the split K10 / K11 (ops 6-9);
// returns the launch's cudaError_t (0 = queued). x: `batch` samples of n
// rows of c values (K7: 2c values, [h | gate]), bf16 (x_bf16) or fp32,
// element strides x_sb and x_sn, 16-byte aligned rows, dense columns; K13's
// and K12's scale and shift: bf16 or fp32 (B, C) views with element strides; K6's w
// and b in the same arguments, batch stride 0 (K10, K7 and K11 ignore
// them); the split's pass 2 takes the row amax (batch * n fp32, dense) as
// `sc`. The plan (threads per row tpr, vectors per
// thread vpt, row groups per block, grid_x blocks per sample) comes from
// `row_plan`; it must cover every column and every row. Writes int8 codes
// (batch * n, c) to `out` and scales (batch * n), both dense; K12 writes y
// (batch * n, c) in x's dtype to `out` and no scales; the split's pass 1
// writes the row amax (batch * n) to `scales` and nothing to `out`.
extern "C" int pd_row_quant(int op, const void* x, int x_bf16, int64_t x_sb, int64_t x_sn,
                            int batch, int n, int c, const void* sc, int sc_bf16, int64_t sc_sb,
                            int64_t sc_sc, const void* sh, int sh_bf16, int64_t sh_sb,
                            int64_t sh_sc, float eps, int tpr, int vpt, int groups, int grid_x,
                            void* out, void* scales, void* stream) {
  const int e = x_bf16 ? 8 : 4;
  const int nvec = c / e;
  const bool tpr_ok = tpr == 8 || tpr == 16 || tpr == 32 || tpr == 64 || tpr == 128 ||
                      tpr == 256;
  const int nin = op == kGeglu ? 2 : 1;
  const bool split = op >= kGeluAmax;
  const bool codes = op != kAdaLNF && op != kGeluAmax && op != kRowsAmax;
  if (op < kGelu || op > kRowsCodes || c <= 0 || c % 8 != 0 || n <= 0 ||
      batch <= 0 || batch > 65535 || !tpr_ok || vpt < 1 || nin * vpt > kMaxVpt ||
      (int64_t)vpt * tpr < nvec ||
      groups < 1 || grid_x < 1 || (int64_t)grid_x * (kThreads / tpr) * groups < n ||
      ((op == kAdaLN || op == kLN || op == kAdaLNF) && (sc == nullptr || sh == nullptr)) ||
      ((op == kGeluCodes || op == kRowsCodes) && sc == nullptr) ||
      (codes && out == nullptr) || (op != kAdaLNF && scales == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.x_sb = x_sb;
  p.x_sn = x_sn;
  p.n = n;
  p.c = c;
  p.tpr = tpr;
  p.groups = groups;
  p.sc = sc;
  p.sc_sb = sc_sb;
  p.sc_sc = sc_sc;
  p.sh = sh;
  p.sh_sb = sh_sb;
  p.sh_sc = sh_sc;
  p.sc_bf16 = sc_bf16;
  p.sh_bf16 = sh_bf16;
  p.eps = eps;
  p.out = out;
  p.scales = static_cast<float*>(scales);
  p.amax = static_cast<const float*>(sc);
  p.gelu = op == kGeluAmax || op == kGeluCodes;
  const dim3 grid(grid_x, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split) {
    return x_bf16 ? launch_split_vpt<__nv_bfloat16>(vpt, op, p, grid, s)
                  : launch_split_vpt<float>(vpt, op, p, grid, s);
  }
  if (x_bf16) {
    return groups > 1 ? launch_vpt<__nv_bfloat16, true>(vpt, op, p, grid, s)
                      : launch_vpt<__nv_bfloat16, false>(vpt, op, p, grid, s);
  }
  return groups > 1 ? launch_vpt<float, true>(vpt, op, p, grid, s)
                    : launch_vpt<float, false>(vpt, op, p, grid, s);
}

// Blocks of K12's backward <bf16 or fp32, vpt> at c columns that one SM
// holds at once; negative: a CUDA error.
extern "C" int pd_adaln_bwd_occupancy(int x_bf16, int vpt, int c) {
  if (c <= 0 || c % 8 != 0) return -static_cast<int>(cudaErrorInvalidValue);
  void* kernel = pick_bwd(x_bf16, vpt, c);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kThreads, sizeof(float) * bwd_smem_floats(c));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// K12's backward on `stream`, one cooperative launch; returns its
// cudaError_t (0 = queued). x and g: `batch` samples of n rows of c values,
// bf16 (x_bf16) or fp32, each with its own element strides, 16-byte
// aligned rows, dense columns; scale as K12's forward takes it. Writes dx
// (batch, n, c) in x's dtype, dscale and dshift (batch, c) in bf16 or fp32,
// all dense; ws: batch * bps * 2c floats, 16-byte aligned. The plan
// (threads per row tpr, vectors per thread vpt, row groups per block, bps
// blocks per sample, lanes per merged sum) comes from
// `adaln_bwd_plan`; it must cover every column and every row, and its grid
// of bps x batch blocks must be resident at once (the cooperative launch
// refuses it otherwise).
extern "C" int pd_adaln_bwd(const void* x, int x_bf16, int64_t x_sb, int64_t x_sn, const void* g,
                            int64_t g_sb, int64_t g_sn, int batch, int n, int c, const void* sc,
                            int sc_bf16, int64_t sc_sb, int64_t sc_sc, float eps, int tpr,
                            int vpt, int groups, int bps, int merge_lanes, void* dx,
                            void* dscale, int dscale_bf16, void* dshift, int dshift_bf16,
                            void* ws, void* stream) {
  const int nvec = c / (x_bf16 ? 8 : 4);
  const bool tpr_ok = tpr == 32 || tpr == 64 || tpr == 128 || tpr == 256;
  const bool lanes_ok = merge_lanes >= 1 && merge_lanes <= kThreads &&
                        (merge_lanes & (merge_lanes - 1)) == 0;
  if (c <= 0 || c % 8 != 0 || n <= 0 || batch <= 0 || batch > 65535 || !tpr_ok || vpt < 1 ||
      vpt > kMaxVpt || (int64_t)vpt * tpr < nvec || groups < 1 || bps < 1 ||
      (int64_t)bps * (kThreads / tpr) * groups < n || !lanes_ok || sc == nullptr ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* kernel = pick_bwd(x_bf16, vpt, c);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.x = x;
  p.x_sb = x_sb;
  p.x_sn = x_sn;
  p.g = g;
  p.g_sb = g_sb;
  p.g_sn = g_sn;
  p.n = n;
  p.c = c;
  p.tpr = tpr;
  p.groups = groups;
  p.bps = bps;
  p.merge_lanes = merge_lanes;
  p.sc = sc;
  p.sc_sb = sc_sb;
  p.sc_sc = sc_sc;
  p.sc_bf16 = sc_bf16;
  p.eps = eps;
  p.dx = dx;
  p.dscale = dscale;
  p.dshift = dshift;
  p.dscale_bf16 = dscale_bf16;
  p.dshift_bf16 = dshift_bf16;
  p.ws = static_cast<float*>(ws);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(bps, batch), dim3(kThreads), args, sizeof(float) * bwd_smem_floats(c),
      static_cast<cudaStream_t>(stream)));
}
