// int8-QK^T attention forward for Hopper (sm_90a) over packed (B, N, H*D)
// tensors: bf16 Q and V, int8 K codes with one scale per (batch, head), or
// one per key row in the lab mode below.
//
// Replaces the TPU kernel prompt_diffusion_tpu/ops/flash_attention.py::
// flash_attention_packed_int8 (_fa_packed_fullk_int8_kernel): the joint
// attention of every SD3 MMDiT and ControlNet block in the int8 serving
// mode. K is quantized outside the kernel (skh[b, h] = max(amax/127, 1e-8),
// codes round(k/skh) clipped to +-127), as the JAX package does it in XLA.
// Per (batch, head) the kernel computes, in the TPU kernel's order:
//
//   sq[i]   = max(max_d |q[i, d]| / 127, 1e-8)           (IEEE division)
//   qc[i,d] = clip(rint(q[i, d] / sq[i]), -127, 127)       (int8)
//   s[i,j]  = f32(sum_d qc[i,d] * kc[j,d]) * (sq[i] * (skh * scale))
//   m[i]    = max_j s[i, j]
//   p[i,j]  = exp(s[i, j] - m[i])                           (fp32)
//   l[i]    = sum_j p[i, j]                                 (fp32)
//   o[i]    = bf16( (sum_j bf16(p[i,j]) * v[j]) / l[i] )   (fp32 sum)
//
// What bounds it: at the SD3 joint shape (B 2, N 4429, H 24, D 64) the two
// matrix products, ~120 GOP of int8 and ~120 GFLOP of bf16 per call, so
// both run on the tensor cores (WMMA s8 16x16x16 into int32 and WMMA bf16
// 16x16x16 into fp32). Design:
//   * one block of 4 warps owns 64 query rows of one (batch, head); each
//     warp owns 16 rows from the logits to the output, so the work between
//     two block barriers is warp-local;
//   * the Q tile is quantized per row in shared memory when it is loaded;
//   * two passes over the keys in tiles of 64: the first takes the row
//     maximum of the logits, the second the exponentials, their sum and
//     P.V. The TPU kernel holds a whole logits row; with the exact maximum
//     first, P.V needs no running correction, so the output accumulators
//     stay in registers (WMMA fragments) and p equals the TPU kernel's
//     exp(s - m) up to the exp implementation. The int8 Q.K^T is computed
//     twice; it is the cheaper of the two products;
//   * the query and key tails are masked in the kernel (no padding);
//   * int8 tiles are stored as [D/16][rows][16], so every 16x16 fragment is
//     256 contiguous bytes, as WMMA's int8 loads require.
// Speed work (cp.async/TMA pipelining, wgmma, a single pass with register
// rescaling) is left to later changes.
//
// ROWK mode: tools/attn_int8_lab.py's v2 (`_kernel_v2`), K quantized per
// (batch, key row, head) outside the kernel, sk (B, H, Nk); the logits are
// f32(s32) * (sq[i] * sk[j]) * scale in that order. The block stages the
// key tile's BK scales beside the codes; everything else is K9's. The lab's
// v3 (`_kernel_v3`, per-head scales) is K9 itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // keys per tile
constexpr int NWARPS = 4;  // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = BK + 4;  // int32 logits pitch
constexpr int LDP = BK + 8;  // bf16 probabilities pitch

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

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int D>
struct Layout {
  static constexpr int LDV = D + 8;  // bf16 V pitch
  static constexpr int LDO = D + 4;  // fp32 output staging pitch
  static constexpr size_t OFF_K = align128((size_t)BQ * D);
  static constexpr size_t OFF_V = OFF_K + align128((size_t)BK * D);
  static constexpr size_t OFF_S = OFF_V + align128((size_t)BK * LDV * 2);
  static constexpr size_t OFF_P = OFF_S + align128((size_t)BQ * LDS * 4);
  static constexpr size_t OFF_O = OFF_P + align128((size_t)BQ * LDP * 2);
  static constexpr size_t OFF_R = OFF_O + align128((size_t)BQ * LDO * 4);
  static constexpr size_t OFF_SK = OFF_R + align128((size_t)2 * BQ * 4);  // sq, l
  static constexpr size_t TOTAL = OFF_SK + align128((size_t)BK * 4);  // ROWK scales
};

// Key tile [k0, k0 + BK) of one head into [D/16][BK][16] (int8 codes) and,
// when V is given, [BK][LDV] (bf16); in ROWK mode its scales into sSk;
// rows past nk are zeros.
template <int D, bool ROWK>
__device__ inline void load_kv(int8_t* sK, __nv_bfloat16* sV, float* sSk, const int8_t* kb,
                               const __nv_bfloat16* vb, const float* skb, const Params& p,
                               int k0) {
  if (ROWK) {
    for (int i = threadIdx.x; i < BK; i += NTHREADS) sSk[i] = (k0 + i < p.nk) ? skb[k0 + i] : 0.f;
  }
  constexpr int KCH = D / 16;  // 16-byte chunks of a K row
  for (int i = threadIdx.x; i < BK * KCH; i += NTHREADS) {
    const int r = i / KCH, c = i % KCH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < p.nk) val = *reinterpret_cast<const uint4*>(kb + (int64_t)(k0 + r) * p.k_sn + c * 16);
    *reinterpret_cast<uint4*>(sK + (c * BK + r) * 16) = val;
  }
  if (sV == nullptr) return;
  constexpr int VCH = D / 8;  // 16-byte chunks of a V row
  for (int i = threadIdx.x; i < BK * VCH; i += NTHREADS) {
    const int r = i / VCH, c = i % VCH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < p.nk) val = *reinterpret_cast<const uint4*>(vb + (int64_t)(k0 + r) * p.v_sn + c * 8);
    *reinterpret_cast<uint4*>(sV + r * Layout<D>::LDV + c * 8) = val;
  }
}

// S = Qc Kc^T (int32) for the warp's 16 rows, stored to sS.
template <int D>
__device__ inline void qk_tile(const int8_t* sQ, const int8_t* sK, int32_t* sS, int wrow) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
    wmma::load_matrix_sync(a, reinterpret_cast<const signed char*>(sQ + (kk * BQ + wrow) * 16), 16);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
      wmma::load_matrix_sync(b, reinterpret_cast<const signed char*>(sK + (kk * BK + n * 16) * 16),
                             16);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::store_matrix_sync(sS + wrow * LDS + n * 16, acc[n], LDS, wmma::mem_row_major);
  }
}

template <int D, bool ROWK>
__global__ void __launch_bounds__(NTHREADS) int8_attn_kernel(Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem);
  int8_t* sK = reinterpret_cast<int8_t*>(smem + L::OFF_K);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_V);
  int32_t* sS = reinterpret_cast<int32_t*>(smem + L::OFF_S);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_P);
  float* sO = reinterpret_cast<float*>(smem + L::OFF_O);
  float* sSq = reinterpret_cast<float*>(smem + L::OFF_R);
  float* sL = sSq + BQ;
  float* sSk = reinterpret_cast<float*>(smem + L::OFF_SK);

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int lane = threadIdx.x % 32;
  const int wrow = (threadIdx.x / 32) * 16;  // first query row of this warp

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * D;
  const int8_t* kb = p.k + b * p.k_sb + h * D;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * D;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * D;
  const float* skb = p.sk + (int64_t)(b * p.heads + h) * p.nk;  // ROWK: this head's row scales
  const float hs = ROWK ? 0.f : __fmul_rn(p.sk[b * p.heads + h], p.scale);  // skh * scale

  // quantize the warp's 16 query rows: D/32 values per lane
  constexpr int PER = D / 32;
  for (int r = wrow; r < wrow + 16; ++r) {
    float x[PER];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane * PER + j;
      x[j] = (q0 + r < p.nq) ? __bfloat162float(qb[(int64_t)(q0 + r) * p.q_sn + c]) : 0.f;
      amax = fmaxf(amax, fabsf(x[j]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float sq = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane * PER + j;
      const float code = fminf(fmaxf(rintf(__fdiv_rn(x[j], sq)), -127.f), 127.f);
      sQ[((c / 16) * BQ + r) * 16 + c % 16] = static_cast<int8_t>(code);
    }
    if (lane == 0) sSq[r] = sq;
  }
  __syncthreads();

  // two lanes per row, 32 logits each
  const int r = wrow + (lane >> 1);
  const int c0 = (lane & 1) * 32;
  const float sq = sSq[r];
  const float f = __fmul_rn(sq, hs);  // sq * (skh * scale)
  // the scaled logit of code sum s at tile column c
  auto logit = [&](int32_t s, int c) {
    return ROWK ? __fmul_rn(__fmul_rn(__int2float_rn(s), __fmul_rn(sq, sSk[c])), p.scale)
                : __fmul_rn(__int2float_rn(s), f);
  };

  // pass 1: the row maximum of the logits
  float m = -INFINITY;
  for (int k0 = 0; k0 < p.nk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_kv<D, ROWK>(sK, nullptr, sSk, kb, vb, skb, p, k0);
    __syncthreads();
    qk_tile<D>(sQ, sK, sS, wrow);
    __syncwarp();
    const int32_t* srow = sS + r * LDS;
    for (int j = 0; j < 32; ++j) {
      const int c = c0 + j;
      if (k0 + c < p.nk) m = fmaxf(m, logit(srow[c], c));
    }
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // pass 2: p = exp(s - m), l = sum p, O = bf16(p) V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  float l = 0.f;
  for (int k0 = 0; k0 < p.nk; k0 += BK) {
    __syncthreads();
    load_kv<D, ROWK>(sK, sV, sSk, kb, vb, skb, p, k0);
    __syncthreads();
    qk_tile<D>(sQ, sK, sS, wrow);
    __syncwarp();
    const int32_t* srow = sS + r * LDS;
    for (int j = 0; j < 32; ++j) {
      const int c = c0 + j;
      float e = 0.f;
      if (k0 + c < p.nk) e = expf(logit(srow[c], c) - m);
      l += e;
      sP[r * LDP + c] = __float2bfloat16_rn(e);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sP + wrow * LDP + kk, LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, sV + kk * L::LDV + n * 16, L::LDV);
        wmma::mma_sync(acc[n], a, bv, acc[n]);
      }
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  if ((lane & 1) == 0) sL[r] = l;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(sO + wrow * L::LDO + n * 16, acc[n], L::LDO, wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int rr = wrow + i / D;
    const int c = i % D;
    if (q0 + rr < p.nq) {
      ob[(int64_t)(q0 + rr) * p.o_sn + c] = __float2bfloat16_rn(__fdiv_rn(sO[rr * L::LDO + c], sL[rr]));
    }
  }
}

template <int D, bool ROWK>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = Layout<D>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(int8_attn_kernel<D, ROWK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nq + BQ - 1) / BQ, batch * p.heads);
  int8_attn_kernel<D, ROWK><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool ROWK>
int launch_d(const Params& p, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch<32, ROWK>(p, batch, s);
    case 64: return launch<64, ROWK>(p, batch, s);
    case 128: return launch<128, ROWK>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// Head dims 32, 64 and 128; every row 16-byte aligned (checked by the
// Python wrapper). `sk` holds (B, H) per-head K scales, or (B, H, Nk)
// per-row ones when `row_k` is set.
extern "C" int pd_int8_attention_fwd(
    const void* q, const void* k, const void* sk, int row_k, const void* v, void* o,
    int batch, int heads, int nq, int nk, int d,
    int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn,
    int64_t v_sb, int64_t v_sn, int64_t o_sb, int64_t o_sn,
    float scale, void* stream) {
  if (nq <= 0 || nk <= 0 || batch <= 0 || heads <= 0 || (int64_t)batch * heads > 65535) {
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
  return row_k ? launch_d<true>(p, batch, d, s) : launch_d<false>(p, batch, d, s);
}
