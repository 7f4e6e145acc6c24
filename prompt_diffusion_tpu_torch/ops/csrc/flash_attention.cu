// Flash attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces two TPU kernels of prompt_diffusion_tpu/ops/flash_attention.py:
//   * flash_attention_packed (_fa_packed_fullk_kernel / _fa_packed_kernel),
//     packed (B, N, H*D) self-attention in the UNet and ControlNet;
//   * flash_attention (_fa_kernel), (B, N, H, D) attention of the VAE
//     mid-block.
// Packed (B, N, H*D) memory is exactly the (B, N, H, D) layout, so one
// strided kernel serves both and no head transposes are made.
//
// The same kernel, with its query and key tile sizes as template
// parameters and a mode, also stands for the attention lab kernels of
// tools/attn_variants.py, attn_lab2.py and attn_lab3.py:
//   * kOnline: softmax attention with an online softmax (`_online_kernel`
//     with do_softmax=True); K1 and K2 are this mode at BQ = BK = 64;
//   * kNoSoftmax: O = sum_j bf16(s_ij * scale) V_j, no max, exp or
//     division (`_online_kernel` with do_softmax=False);
//   * kTwoPass: the "full-K" kernels (`_fullk_kernel`, `_fullk_packed*`,
//     `_fullk_batched_heads`), which hold a whole logits row and take one
//     softmax. A Hopper block cannot hold the row, so it makes two passes
//     over the keys: the exact row maximum first, then exp(s - m), its
//     fp32 sum and bf16 P.V with no rescaling, the accumulators in
//     registers. This is the structure of the int8 kernel K9, in bf16.
// The instantiated tiles are BQ in {64, 128} and BK in {32, 64, 128};
// any other pair is refused at launch.
//
// Numerics follow the TPU kernels: logits, running max and running sum in
// fp32; P is rounded to bf16 before P.V; the P.V accumulator is fp32 and is
// divided by the running sum at the end; the sum is taken over the fp32 P.
//
// What bounds it: at the SD1.5 shapes (N = 4096 or 1024 keys, D = 40, 80
// or 512) the work is the two matrix products, so the kernel runs them on
// the tensor cores (WMMA bf16 16x16x16 fragments, fp32 accumulation).
// Design:
//   * one block of BQ/16 warps owns BQ query rows of one (batch, head) and
//     one chunk of at most 128 output columns; it streams K/V in tiles of
//     BK keys, so the Nq x Nk logits never reach device memory. Each warp
//     owns 16 query rows from the logits to the output, so the tile work
//     between two block barriers is warp-local;
//   * D = 40 and 80 are not multiples of 16: the head dimension is
//     zero-padded to a multiple of 16 inside shared memory, never in HBM;
//   * D = 512 (the VAE) would need a 512-wide fp32 accumulator row per
//     query: the output columns are split over blocks (grid.y), each block
//     recomputing the logits over the full head dimension;
//   * the query and key tails are masked in the kernel (no padding);
//   * kOnline keeps the P.V accumulator in shared memory (fp32), so the
//     per-row online-softmax correction is a plain loop over it; the other
//     two modes never rescale and keep it in WMMA fragments.
// Loads are 16 bytes a thread; the wrapper checks D % 8 == 0 and 16-byte
// alignment of every row. Speed work (cp.async/TMA pipelining, wgmma,
// register accumulators in kOnline) is left to later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

enum Mode { kOnline = 0, kNoSoftmax = 1, kTwoPass = 2 };

constexpr int DV_MAX = 128;   // widest output chunk one block holds
constexpr int D_MAX = 512;    // the Q and K tiles must fit shared memory
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may use

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
  int dpad;  // d rounded up to 16
  int dv;    // output columns per block (multiple of 16)
  float scale;
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

struct Layout {
  int ldq, ldv, lds, ldp, ldo;
  size_t off_k, off_v, off_s, off_p, off_o, off_m, total;
};

__host__ __device__ inline Layout make_layout(int dpad, int dv, int bq, int bk) {
  Layout L;
  L.ldq = dpad + 8;  // Q and K tiles (bf16)
  L.ldv = dv + 8;    // V tile chunk (bf16)
  L.lds = bk + 4;    // logits (fp32)
  L.ldp = bk + 8;    // probabilities (bf16)
  L.ldo = dv + 4;    // output accumulator (fp32)
  size_t off = align128((size_t)bq * L.ldq * 2);
  L.off_k = off;  off += align128((size_t)bk * L.ldq * 2);
  L.off_v = off;  off += align128((size_t)bk * L.ldv * 2);
  L.off_s = off;  off += align128((size_t)bq * L.lds * 4);
  L.off_p = off;  off += align128((size_t)bq * L.ldp * 2);
  L.off_o = off;  off += align128((size_t)bq * L.ldo * 4);
  L.off_m = off;  off += align128((size_t)3 * bq * 4);  // max, sum, correction
  L.total = off;
  return L;
}

// Copy rows [r0, r0 + ROWS) and columns [c0, c0 + width) of a strided bf16
// matrix into shared memory, 8 elements (16 bytes) per access; rows past
// nrows and columns past d are written as zeros.
template <int ROWS, int NT>
__device__ inline void load_tile(__nv_bfloat16* dst, int ld,
                                 const __nv_bfloat16* src, int64_t stride,
                                 int r0, int nrows, int c0, int d, int width) {
  const int chunks = width / 8;
  for (int i = threadIdx.x; i < ROWS * chunks; i += NT) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows && c0 + c < d) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * stride + c0 + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// S = Q K^T for the warp's 16 rows (fp32 accumulation), stored to sS.
template <int BK>
__device__ inline void qk_tile(const __nv_bfloat16* sQ, const __nv_bfloat16* sK, float* sS,
                               const Layout& L, int dpad, int wrow) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int kk = 0; kk < dpad; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sQ + wrow * L.ldq + kk, L.ldq);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, sK + (n * 16) * L.ldq + kk, L.ldq);
      wmma::mma_sync(acc[n], a, bf, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::store_matrix_sync(sS + wrow * L.lds + n * 16, acc[n], L.lds, wmma::mem_row_major);
  }
}

template <int BQ, int BK, int MODE>
__global__ void __launch_bounds__(BQ / 16 * 32) fa_fwd_kernel(Params p) {
  constexpr int NT = BQ / 16 * 32;  // each warp owns 16 query rows
  constexpr int HALF = BK / 2;      // logits per lane: two lanes per row
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(p.dpad, p.dv, BQ, BK);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L.off_k);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L.off_v);
  float* sS = reinterpret_cast<float*>(smem + L.off_s);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L.off_p);
  float* sO = reinterpret_cast<float*>(smem + L.off_o);
  float* sM = reinterpret_cast<float*>(smem + L.off_m);
  float* sL = sM + BQ;
  float* sC = sL + BQ;

  const int q0 = blockIdx.x * BQ;
  const int dv0 = blockIdx.y * p.dv;
  const int b = blockIdx.z / p.heads;
  const int h = blockIdx.z % p.heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wrow = warp * 16;  // first query row this warp owns
  const int r = wrow + (lane >> 1);  // the row of this lane's half of the logits
  const int c0 = (lane & 1) * HALF;
  float* srow = sS + r * L.lds;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;

  load_tile<BQ, NT>(sQ, L.ldq, qb, p.q_sn, q0, p.nq, 0, p.d, p.dpad);

  if (MODE == kOnline) {
    for (int i = tid; i < BQ * L.ldo; i += NT) sO[i] = 0.f;
    if (tid < BQ) {
      sM[tid] = -INFINITY;
      sL[tid] = 0.f;
    }
    for (int k0 = 0; k0 < p.nk; k0 += BK) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<BK, NT>(sK, L.ldq, kb, p.k_sn, k0, p.nk, 0, p.d, p.dpad);
      load_tile<BK, NT>(sV, L.ldv, vb, p.v_sn, k0, p.nk, dv0, p.d, p.dv);
      __syncthreads();
      qk_tile<BK>(sQ, sK, sS, L, p.dpad, wrow);
      __syncwarp();

      // online softmax: two lanes per row, BK/2 columns each
      float mx = -INFINITY;
      for (int j = 0; j < HALF; ++j) {
        const int c = c0 + j;
        const float s = (k0 + c < p.nk) ? srow[c] * p.scale : -INFINITY;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = 0; j < HALF; ++j) {
        const int c = c0 + j;
        const float e = expf(srow[c] - m_new);
        sum += e;
        sP[r * L.ldp + c] = __float2bfloat16(e);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((lane & 1) == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first tile
        sM[r] = m_new;
        sL[r] = sL[r] * corr + sum;
        sC[r] = corr;
      }
      __syncwarp();

      // O = O * corr + P V for this warp's rows
      for (int i = lane; i < 16 * p.dv; i += 32) {
        const int rr = wrow + i / p.dv;
        sO[rr * L.ldo + i % p.dv] *= sC[rr];
      }
      __syncwarp();
      for (int n = 0; n < p.dv; n += 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::load_matrix_sync(o, sO + wrow * L.ldo + n, L.ldo, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(a, sP + wrow * L.ldp + kk, L.ldp);
          wmma::load_matrix_sync(bf, sV + kk * L.ldv + n, L.ldv);
          wmma::mma_sync(o, a, bf, o);
        }
        wmma::store_matrix_sync(sO + wrow * L.ldo + n, o, L.ldo, wmma::mem_row_major);
      }
    }
  } else {
    // kTwoPass, pass 1: the exact row maximum of the scaled logits
    float m = 0.f;
    if (MODE == kTwoPass) {
      m = -INFINITY;
      for (int k0 = 0; k0 < p.nk; k0 += BK) {
        __syncthreads();
        load_tile<BK, NT>(sK, L.ldq, kb, p.k_sn, k0, p.nk, 0, p.d, p.dpad);
        __syncthreads();
        qk_tile<BK>(sQ, sK, sS, L, p.dpad, wrow);
        __syncwarp();
        for (int j = 0; j < HALF; ++j) {
          const int c = c0 + j;
          if (k0 + c < p.nk) m = fmaxf(m, srow[c] * p.scale);
        }
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    }

    // P = exp(s - m) (kTwoPass) or s (kNoSoftmax), O += bf16(P) V in registers
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DV_MAX / 16];
#pragma unroll
    for (int n = 0; n < DV_MAX / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
    float l = 0.f;
    for (int k0 = 0; k0 < p.nk; k0 += BK) {
      __syncthreads();
      load_tile<BK, NT>(sK, L.ldq, kb, p.k_sn, k0, p.nk, 0, p.d, p.dpad);
      load_tile<BK, NT>(sV, L.ldv, vb, p.v_sn, k0, p.nk, dv0, p.d, p.dv);
      __syncthreads();
      qk_tile<BK>(sQ, sK, sS, L, p.dpad, wrow);
      __syncwarp();
      for (int j = 0; j < HALF; ++j) {
        const int c = c0 + j;
        float e = 0.f;
        if (k0 + c < p.nk) {
          const float s = srow[c] * p.scale;
          e = (MODE == kTwoPass) ? expf(s - m) : s;
        }
        l += e;
        sP[r * L.ldp + c] = __float2bfloat16(e);
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sP + wrow * L.ldp + kk, L.ldp);
#pragma unroll
        for (int n = 0; n < DV_MAX / 16; ++n) {
          if (n * 16 < p.dv) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
            wmma::load_matrix_sync(bf, sV + kk * L.ldv + n * 16, L.ldv);
            wmma::mma_sync(acc[n], a, bf, acc[n]);
          }
        }
      }
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    if ((lane & 1) == 0) sL[r] = (MODE == kTwoPass) ? l : 1.f;
#pragma unroll
    for (int n = 0; n < DV_MAX / 16; ++n) {
      if (n * 16 < p.dv) {
        wmma::store_matrix_sync(sO + wrow * L.ldo + n * 16, acc[n], L.ldo, wmma::mem_row_major);
      }
    }
  }
  __syncwarp();

  for (int i = lane; i < 16 * p.dv; i += 32) {
    const int rr = wrow + i / p.dv;
    const int c = i % p.dv;
    const int qi = q0 + rr;
    const int dc = dv0 + c;
    if (qi < p.nq && dc < p.d) {
      ob[(int64_t)qi * p.o_sn + dc] = __float2bfloat16(sO[rr * L.ldo + c] / sL[rr]);
    }
  }
}

template <int BQ, int BK, int MODE>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const Layout L = make_layout(p.dpad, p.dv, BQ, BK);
  if (L.total > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<BQ, BK, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.nq + BQ - 1) / BQ, (p.dpad + p.dv - 1) / p.dv, batch * p.heads);
  fa_fwd_kernel<BQ, BK, MODE><<<grid, BQ / 16 * 32, L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_tiles(const Params& p, int batch, int bq, int bk, cudaStream_t s) {
  if (bq == 64) {
    if (bk == 32) return launch<64, 32, MODE>(p, batch, s);
    if (bk == 64) return launch<64, 64, MODE>(p, batch, s);
    if (bk == 128) return launch<64, 128, MODE>(p, batch, s);
  } else if (bq == 128) {
    if (bk == 32) return launch<128, 32, MODE>(p, batch, s);
    if (bk == 64) return launch<128, 64, MODE>(p, batch, s);
    if (bk == 128) return launch<128, 128, MODE>(p, batch, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* pd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// mode: 0 online softmax, 1 no softmax, 2 two passes; (block_q, block_k)
// one of the instantiated tiles (K1 and K2: mode 0 at 64 x 64).
extern "C" int pd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int batch, int heads, int nq, int nk, int d,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sn, int64_t k_sh,
    int64_t v_sb, int64_t v_sn, int64_t v_sh,
    int64_t o_sb, int64_t o_sn, int64_t o_sh,
    float scale, int mode, int block_q, int block_k, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > D_MAX || nq <= 0 || nk <= 0 || batch <= 0 ||
      heads <= 0 || (int64_t)batch * heads > 65535) {
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
  p.dpad = (d + 15) / 16 * 16;
  p.dv = p.dpad < DV_MAX ? p.dpad : DV_MAX;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kOnline: return launch_tiles<kOnline>(p, batch, block_q, block_k, s);
    case kNoSoftmax: return launch_tiles<kNoSoftmax>(p, batch, block_q, block_k, s);
    case kTwoPass: return launch_tiles<kTwoPass>(p, batch, block_q, block_k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
