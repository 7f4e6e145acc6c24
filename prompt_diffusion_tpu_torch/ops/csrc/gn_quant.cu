// GroupNorm(+SiLU) -> int8 for Hopper (sm_90a): K5, one launch per call.
//
// Replaces the TPU kernel prompt_diffusion_tpu/ops/fused_group_norm.py::
// fused_group_norm_quant (_gn_quant_kernel): the GroupNorm in front of
// every 3x3 conv of an SD1.5 ResBlock (with SiLU) and every
// SpatialTransformer's proj_in (without) in the int8 serving mode, and the
// int8 VAE's. Per sample b of a (B, H, W, C) activation (an NCHW tensor in
// channels_last memory), in fp32:
//
//   mean and variance of each of the G channel groups over H x W x C/G
//   values (the variance of the deviations, as the plain version);
//   z = (x - mean) * gamma * rsqrt(var + eps) + beta, optionally SiLU
//   (computed as x * sc + sh, one FMA, sc = gamma * rsqrt(var + eps) and
//   sh = beta - mean * sc, as K3 and the parent Triton program fold it);
//   s = max(amax|z| / 127, 1e-8) by IEEE division, one scale per sample,
//   and the codes rint(z / s), the IEEE quotient, clipped to +-127.
//
// What bounds it on the H100: bytes, one read of the bf16 activation and one
// write of its int8 codes (3 bytes a value): 0.0094 ms at the SD1.5 64²
// site (8, 320, 64, 64) at 3.35 TB/s. The work is two reductions across
// the whole sample (the group statistics, then the amax), each of which
// must finish before anything after it can start. The TPU kernel held a
// sample in VMEM; a Hopper SM holds 227 KB of shared memory, and a sample is
// 2.6 MB (64²) to 67 MB (the VAE at 512²). The design:
//   * one launch of a persistent grid, every block resident (a cooperative
//     launch sized by the occupancy query), with two grid barriers
//     (cooperative_groups::this_grid().sync(), so no counter needs a memset);
//     each block owns a contiguous range of one sample's pixels, cut into
//     chunks of R x K pixels (`gn_plan` in ops/gn_quant.py);
//   * a block is CV x R threads (rounded up to whole warps; the rest idle),
//     CV = C / 8 (bf16) the 16-byte vectors of a pixel: thread (r, v) reads
//     vector v of pixels r, r + R, ... of each chunk, so the block's loads
//     of a chunk are one contiguous stretch and each thread's channels
//     never change;
//   * phase 1 reads each chunk once into registers (K 16-byte loads a
//     thread in flight), keeps per thread and channel the mean and M2 (each
//     chunk's own mean and squared deviations, merged by Chan's formula: no
//     E[x²] - E[x]² on the VAE's large-mean activations) and the min and
//     max of x; the block merges its rows, then its channels, into one (count, mean,
//     M2) per group in the workspace, as K3's combine program merges its
//     tiles: the weighted mean of the parts' means, then the sum of their
//     M2 and n (mean_part - mean)^2 (two passes of adds, no chain of
//     divisions). Barrier;
//   * every block merges its sample's block partials per group in one
//     pass of sums about block 0's group mean, spread over the block's
//     threads (each summing every nl-th block, all its loads independent),
//     then added in lane order (the same bits in every block, and on every
//     run), and folds
//     gamma * rstd and the mean into per-channel sc and sh (gamma and beta
//     were staged in shared memory before the barrier). Phase 2, the amax,
//     reads no value: z is monotone in x within a channel (one FMA, rounded
//     monotonically), so |z| peaks at the channel's min or
//     max of x. SiLU breaks this only below its minimum -0.2785 at z =
//     -1.278, where |SiLU| <= 0.2785: where the block's endpoint amax is at
//     least kSiluFloor, no interior value can exceed it; else the block takes
//     its amax over its values (a pass, rare: an all-but-constant sample).
//     One float per block to the workspace. Barrier;
//   * phase 3 takes the sample's amax over its blocks, the scale once, then
//     reads each chunk again, from L2 where the activation fits there (a
//     copy of the chunks in shared memory, cp.async'd in phase 1, measured
//     no faster in `quant_tune`'s sweep): z, SiLU as
//     z * rcp(1 + 2^(-z log2 e)) (two special-function operations), the
//     quotient z * (1/s) with one FMA correction (equal to
//     __fdiv_rn, quant_common.cuh), rint by the 1.5 * 2^23 shift, four
//     codes packed by byte permutes, 8 bytes stored per thread and vector.
// Every sum is taken in a fixed order (per thread, then rows, then channels,
// then blocks in lane order), so a call repeats bit for bit. Merging the
// parts by Chan's formula one at a time would chain two IEEE divisions per
// part, a dependent chain as long as the parts (80 channels a group at 8²).
// `quant_tune --part phases` stamps each phase's cycles.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "quant_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kWarp = 32;
// > the largest |SiLU(z)| for z <= 0 (0.27846 at z = -1.27846)
constexpr float kSiluFloor = 0.28f;
constexpr float kNegLog2e = -1.4426950408889634f;

struct GnParams {
  const void* x;       // (B, HW, C), dense
  const float* gamma;  // (C,)
  const float* beta;   // (C,)
  int8_t* codes;       // (B, HW, C), dense
  float* scales;       // (B,)
  float* ws;           // grid * 3 G group partials, then grid block amaxes
  int hw, c, groups;
  int cv, rows;     // 16-byte vectors per pixel; pixel rows in flight (threads >= cv * rows)
  int chunks, bps;  // chunks of rows * K pixels per sample; blocks per sample
  float eps;
};

// Float bits as ints that order as the floats do (min and max by integer
// atomics in shared memory: exact, in any order).
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

template <bool SILU>
__device__ __forceinline__ float epilogue(float z) {
  if constexpr (SILU) {
    float e, r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(__fmul_rn(z, kNegLog2e)));
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fadd_rn(1.0f, e)));
    return __fmul_rn(z, r);
  } else {
    return z;
  }
}

// The block's max of v (v >= 0), in every thread; `wred` holds a float per
// warp (blocks are whole warps).
__device__ __forceinline__ float block_max(float v, float* wred) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int nw = (blockDim.x + kWarp - 1) / kWarp;
  __syncthreads();
  if ((threadIdx.x & (kWarp - 1)) == 0) wred[threadIdx.x / kWarp] = v;
  __syncthreads();
  float m = 0.f;
  for (int w = 0; w < nw; ++w) m = fmaxf(m, wred[w]);
  return m;
}

// Shared memory of a block (floats), as
// `gn_quant.static_smem` counts it: red, the larger of 2 R C (per-row
// channel means and M2; then sc and sh) and R C + 3 max(threads, G) (the
// channel means and the lanes of the sample's merge); cmin, cmax, gamma and
// beta C each, nrow R, gstat 2 G, wred 32.
__host__ __device__ inline int red_floats(int c, int rows, int groups, int threads) {
  const int lanes = rows * c + 3 * (threads > groups ? threads : groups);
  return 2 * rows * c > lanes ? 2 * rows * c : lanes;
}

__host__ __device__ inline int static_floats(int c, int rows, int groups, int threads) {
  const int n = red_floats(c, rows, groups, threads) + 4 * c + rows + 2 * groups + kWarp;
  return n;
}

template <typename T, int K, bool SILU>
__global__ void __launch_bounds__(kMaxThreads) gn_quant_kernel(const GnParams p) {
  constexpr int E = Vec<T>::E;
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x, t = threadIdx.x;
  const int C = p.c, G = p.groups, CG = C / G, R = p.rows;
  const int v = t % p.cv, r = t / p.cv;
  const bool active = r < R;  // the threads past cv * rows only join the reductions
  float* red = reinterpret_cast<float*>(smem4);
  int* cmin = reinterpret_cast<int*>(red + red_floats(C, R, G, nt));
  int* cmax = cmin + C;
  float* gb = reinterpret_cast<float*>(cmax + C);  // gamma, then beta
  float* nrow = gb + 2 * C;
  float* gstat = nrow + R;
  float* wred = gstat + 2 * G;

  const int blk = blockIdx.x, b = blk / p.bps, j = blk % p.bps;
  const int ch0 = static_cast<int>((int64_t)j * p.chunks / p.bps);
  const int ch1 = static_cast<int>((int64_t)(j + 1) * p.chunks / p.bps);
  const int cpix = R * K;
  const uint4* xs = reinterpret_cast<const uint4*>(static_cast<const T*>(p.x) +
                                                   (int64_t)b * p.hw * C);
  // pixel of row k of chunk ch for this thread, and how many of its K are
  // inside the sample (a prefix)
  auto pixel = [&](int ch, int k) { return ch * cpix + k * R + r; };
  auto valid = [&](int ch) {
    const int first = pixel(ch, 0);
    return first >= p.hw ? 0 : min(K, (p.hw - first + R - 1) / R);
  };
  auto load = [&](int ch, uint4 (&raw)[K]) {
    const int kv = active ? valid(ch) : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      raw[k] = k < kv ? __ldg(xs + (int64_t)pixel(ch, k) * p.cv + v) : make_uint4(0, 0, 0, 0);
    }
    return kv;
  };

  for (int i = t; i < C; i += nt) {
    gb[i] = p.gamma[i];  // read now, used after the first barrier
    gb[C + i] = p.beta[i];
    cmin[i] = INT_MAX;
    cmax[i] = INT_MIN;
  }

  // ---- phase 1: per-thread channel statistics, min and max
  float n = 0.f, mean[E], m2[E], lo[E], hi[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    mean[e] = m2[e] = 0.f;
    lo[e] = __int_as_float(0x7f800000);
    hi[e] = -lo[e];
  }
  for (int ch = ch0; active && ch < ch1; ++ch) {
    uint4 raw[K];
    const int kv = load(ch, raw);
    if (kv == 0) continue;
    float sum[E], f[E];
#pragma unroll
    for (int e = 0; e < E; ++e) sum[e] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kv) {
        Vec<T>::unpack(raw[k], f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          sum[e] += f[e];
          lo[e] = fminf(lo[e], f[e]);
          hi[e] = fmaxf(hi[e], f[e]);
        }
      }
    }
    const float fk = static_cast<float>(kv), inv = __fdiv_rn(1.0f, fk);
    float dev[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      sum[e] *= inv;  // the chunk's mean
      dev[e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kv) {
        Vec<T>::unpack(raw[k], f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = f[e] - sum[e];
          dev[e] = fmaf(d, d, dev[e]);
        }
      }
    }
    if (n == 0.f) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        mean[e] = sum[e];
        m2[e] = dev[e];
      }
      n = fk;
    } else {
      const float nn = n + fk, w = __fdiv_rn(fk, nn), q = __fdiv_rn(n * fk, nn);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float delta = sum[e] - mean[e];
        mean[e] = fmaf(delta, w, mean[e]);
        m2[e] = m2[e] + dev[e] + delta * delta * q;
      }
      n = nn;
    }
  }
  __syncthreads();  // cmin and cmax set
  if (active) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      red[r * C + v * E + e] = mean[e];
      red[(R + r) * C + v * E + e] = m2[e];
      if (n > 0.f) {
        atomicMin(cmin + v * E + e, ordered(lo[e]));
        atomicMax(cmax + v * E + e, ordered(hi[e]));
      }
    }
    if (v == 0) nrow[r] = n;
  }
  __syncthreads();
  // the block's rows, per channel, then its channels, per group (equal
  // counts nb): the weighted mean of the parts' means, then the sum of
  // their M2 and of n (mean_part - mean)^2, as K3's combine program: two
  // passes of adds in index order, no division per part
  float nb = 0.f;
  for (int rr = 0; rr < R; ++rr) nb += nrow[rr];
  const float inv_nb = __fdiv_rn(1.0f, nb);
  for (int c = t; c < C; c += nt) {
    float sum = 0.f;
    for (int rr = 0; rr < R; ++rr) sum = fmaf(nrow[rr], red[rr * C + c], sum);
    const float cm = sum * inv_nb;
    float cm2 = 0.f;
    for (int rr = 0; rr < R; ++rr) {  // a row without pixels holds 0, 0
      const float d = red[rr * C + c] - cm;
      cm2 += fmaf(nrow[rr] * d, d, red[(R + rr) * C + c]);
    }
    red[c] = cm;          // row 0's slots, read above by this thread only
    red[R * C + c] = cm2;
  }
  __syncthreads();
  float* part = p.ws + (int64_t)blk * 3 * G;
  const float inv_cg = __fdiv_rn(1.0f, static_cast<float>(CG));
  const int lane = t & (kWarp - 1);
  auto warp_sum = [](float x) {  // xor butterflies: every lane the same sum
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
  };
  for (int g = t / kWarp; g < G; g += nt / kWarp) {  // a warp per group
    float sum = 0.f;
    for (int c = g * CG + lane; c < (g + 1) * CG; c += kWarp) sum += red[c];
    const float gm = warp_sum(sum) * inv_cg;
    float gm2 = 0.f;
    for (int c = g * CG + lane; c < (g + 1) * CG; c += kWarp) {
      const float d = red[c] - gm;
      gm2 += fmaf(nb * d, d, red[R * C + c]);
    }
    gm2 = warp_sum(gm2);
    if (lane == 0) {
      part[3 * g] = nb * CG;
      part[3 * g + 1] = gm;
      part[3 * g + 2] = gm2;
    }
  }
  cg::this_grid().sync();

  // ---- the sample's group statistics: nl = nt / G threads per group,
  // thread (l, g) summing blocks l, l + nl, ... of group g about a shift,
  // block 0's group mean (the same in every thread; the blocks' means lie
  // within a few standard errors of it, so the shifted sums lose nothing
  // to cancellation), all loads of a thread independent; then the nl
  // lanes of a group in lane order through shared memory
  const float* parts = p.ws + (int64_t)b * p.bps * 3 * G;
  const int nl = max(1, nt / G);
  float* lanes = red + R * C;  // 3 nl G floats, past the channel means
  for (int i = t; i < nl * G; i += nt) {
    const int g = i % G, l = i / G;
    const float shift = parts[3 * g + 1];
    float n = 0.f, s1 = 0.f, s2 = 0.f;
    for (int jj = l; jj < p.bps; jj += nl) {
      const float* q = parts + (int64_t)jj * 3 * G + 3 * g;
      const float d = q[1] - shift;
      n += q[0];
      s1 = fmaf(q[0], d, s1);
      s2 += fmaf(q[0] * d, d, q[2]);
    }
    lanes[3 * i] = n;
    lanes[3 * i + 1] = s1;
    lanes[3 * i + 2] = s2;
  }
  __syncthreads();
  for (int g = t; g < G; g += nt) {
    float n = 0.f, s1 = 0.f, s2 = 0.f;
    for (int l = 0; l < nl; ++l) {
      n += lanes[3 * (l * G + g)];
      s1 += lanes[3 * (l * G + g) + 1];
      s2 += lanes[3 * (l * G + g) + 2];
    }
    const float d = __fdiv_rn(s1, n);  // the group mean less the shift
    gstat[2 * g] = parts[3 * g + 1] + d;
    gstat[2 * g + 1] = rsqrtf(__fdiv_rn(fmaf(-s1, d, s2), n) + p.eps);
  }
  __syncthreads();
  float* sc = red;  // gamma * rstd and beta - mean * that, per channel
  float* sh = red + C;
  for (int c = t; c < C; c += nt) {
    const int g = c / CG;
    sc[c] = gb[c] * gstat[2 * g + 1];
    sh[c] = fmaf(-gstat[2 * g], sc[c], gb[C + c]);
  }
  __syncthreads();

  // ---- phase 2: the block's amax from each channel's min and max of x
  float amax = 0.f;
  for (int c = t; c < C; c += nt) {
    const float zl = epilogue<SILU>(fmaf(unordered(cmin[c]), sc[c], sh[c]));
    const float zh = epilogue<SILU>(fmaf(unordered(cmax[c]), sc[c], sh[c]));
    amax = fmaxf(amax, fmaxf(fabsf(zl), fabsf(zh)));
  }
  amax = block_max(amax, wred);
  float csc[E], csh[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {  // an idle thread's v is a real channel vector
    csc[e] = sc[v * E + e];
    csh[e] = sh[v * E + e];
  }
  if (SILU && amax < kSiluFloor) {  // a SiLU minimum may lie inside a channel's range
    amax = 0.f;
    for (int ch = ch0; ch < ch1; ++ch) {
      uint4 raw[K];
      const int kv = load(ch, raw);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < kv) {
          float f[E];
          Vec<T>::unpack(raw[k], f);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            amax = fmaxf(amax, fabsf(epilogue<SILU>(fmaf(f[e], csc[e], csh[e]))));
          }
        }
      }
    }
    amax = block_max(amax, wred);
  }
  float* amaxes = p.ws + (int64_t)gridDim.x * 3 * G;
  if (t == 0) amaxes[blk] = amax;
  cg::this_grid().sync();

  // ---- phase 3: the sample's scale, then the codes
  float m = 0.f;
  for (int jj = t; jj < p.bps; jj += nt) m = fmaxf(m, amaxes[b * p.bps + jj]);
  m = block_max(m, wred);
  const float s = fmaxf(__fdiv_rn(m, 127.f), 1e-8f);
  const float rs = __frcp_rn(s);
  if (j == 0 && t == 0) p.scales[b] = s;
  int8_t* out = p.codes + (int64_t)b * p.hw * C + v * E;
  for (int ch = ch0; active && ch < ch1; ++ch) {
    uint4 raw[K];
    const int kv = load(ch, raw);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kv) {
        float f[E];
        Vec<T>::unpack(raw[k], f);
        uint32_t w[E / 4];
#pragma unroll
        for (int h = 0; h < E / 4; ++h) {
          uint32_t code[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * h + i;
            const float z = epilogue<SILU>(fmaf(f[e], csc[e], csh[e]));
            code[i] = rq::code_bits(rq::quotient(z, s, rs));
          }
          w[h] = rq::pack4(code[0], code[1], code[2], code[3]);
        }
        int8_t* dst = out + (int64_t)pixel(ch, k) * C;
        if constexpr (E == 8) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
        } else {
          *reinterpret_cast<uint32_t*>(dst) = w[0];
        }
      }
    }
  }
}

template <typename T, int K, bool SILU>
void* kernel_of() {
  return reinterpret_cast<void*>(gn_quant_kernel<T, K, SILU>);
}

void* pick(int x_bf16, int k, int silu) {
#define PD_GN_PICK(T)                                                                   \
  switch (k) {                                                                          \
    case 1: return silu ? kernel_of<T, 1, true>() : kernel_of<T, 1, false>();           \
    case 2: return silu ? kernel_of<T, 2, true>() : kernel_of<T, 2, false>();           \
    case 4: return silu ? kernel_of<T, 4, true>() : kernel_of<T, 4, false>();           \
    case 8: return silu ? kernel_of<T, 8, true>() : kernel_of<T, 8, false>();           \
    default: return nullptr;                                                            \
  }
  if (x_bf16) {
    PD_GN_PICK(__nv_bfloat16)
  }
  PD_GN_PICK(float)
#undef PD_GN_PICK
}

// Lets the kernel take all of an SM's shared memory a block may have.
cudaError_t allow_smem(void* kernel) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }
  return err;
}

}  // namespace

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory that
// one SM holds at once for the kernel <bf16 or fp32, k, silu>; negative: a
// CUDA error.
extern "C" int pd_gn_quant_occupancy(int x_bf16, int k, int silu, int threads, int smem) {
  void* kernel = pick(x_bf16, k, silu);
  if (kernel == nullptr || threads < 1 || threads > kMaxThreads) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// K5 on `stream`: returns the launch's cudaError_t (0 = queued). x: `batch`
// samples of hw pixels of c values (bf16 if x_bf16, else fp32), dense,
// 16-byte aligned; gamma and beta fp32 (c,); codes (batch, hw, c) int8 and
// scales (batch,) fp32; ws: batch * bps * (3 groups + 1) floats. The plan
// (vectors per thread k, pixel rows, threads per block, chunks per sample,
// blocks per sample) comes from `gn_plan`; its grid of batch * bps blocks
// must be resident at once (the cooperative launch refuses it otherwise).
extern "C" int pd_gn_quant(const void* x, int x_bf16, const void* gamma, const void* beta,
                           void* codes, void* scales, void* ws, int batch, int hw, int c,
                           int groups, float eps, int silu, int k, int rows, int threads,
                           int chunks, int bps, void* stream) {
  const int e = x_bf16 ? 8 : 4;
  const int cv = c / e;
  void* kernel = pick(x_bf16, k, silu);
  if (kernel == nullptr || batch < 1 || hw < 1 || c < 1 || c % 8 != 0 || groups < 1 ||
      c % groups != 0 || rows < 1 || threads < cv * rows || threads % kWarp != 0 ||
      threads > kMaxThreads || chunks < 1 ||
      (int64_t)chunks * rows * k < hw || bps < 1 || bps > chunks ||
      (int64_t)batch * bps > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  GnParams p;
  p.x = x;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.codes = static_cast<int8_t*>(codes);
  p.scales = static_cast<float*>(scales);
  p.ws = static_cast<float*>(ws);
  p.hw = hw;
  p.c = c;
  p.groups = groups;
  p.cv = cv;
  p.rows = rows;
  p.chunks = chunks;
  p.bps = bps;
  p.eps = eps;
  void* args[] = {&p};
  const size_t smem = sizeof(float) * static_floats(c, rows, groups, threads);
  err = cudaLaunchCooperativeKernel(kernel, dim3(batch * bps), dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
