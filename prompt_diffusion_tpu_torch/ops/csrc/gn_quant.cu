// GroupNorm(+SiLU or ReLU) for Hopper (sm_90a), one launch per call each:
// K5, GroupNorm(+SiLU) -> int8 (`gn_quant_kernel`), and K3, GroupNorm(+SiLU
// or ReLU) in the input's dtype (`gn_float_kernel`).
//
// K5 replaces the TPU kernel prompt_diffusion_tpu/ops/fused_group_norm.py::
// fused_group_norm_quant (_gn_quant_kernel): the GroupNorm in front of
// every 3x3 conv of an SD1.5 ResBlock (with SiLU) and every
// SpatialTransformer's proj_in (without) in the int8 serving mode, and the
// int8 VAE's. K3 replaces fused_group_norm (_gn_kernel, and the two-pass
// _stats_kernel + _apply_kernel above 8 MB samples): the same GroupNorms in
// bf16 or fp32, the SD3 VAE's and the MiDaS DPT-Hybrid backbone's (timm's
// GroupNormAct, ReLU). Per sample b of a (B, H, W, C) activation (an NCHW
// tensor in channels_last memory), in fp32:
//
//   mean and variance of each of the G channel groups over H x W x C/G
//   values (the variance of the deviations, as the plain version);
//   z = (x - mean) * gamma * rsqrt(var + eps) + beta, then SiLU, ReLU or
//   nothing (computed as x * sc + sh, one FMA, sc = gamma * rsqrt(var +
//   eps) and sh = beta - mean * sc);
//   K3: z stored in x's dtype (bf16 rounded to nearest, as a cast);
//   K5: s = max(amax|z| / 127, 1e-8) by IEEE division, one scale per
//   sample, and the codes rint(z / s), the IEEE quotient, clipped to +-127.
//
// What bounds them on the H100: bytes. K5 reads the bf16 activation once and
// writes its int8 codes (3 bytes a value): 0.0094 ms at the SD1.5 64² site
// (8, 320, 64, 64) at 3.35 TB/s; K3 reads and writes it (4 bytes a value):
// 0.0125 ms there. Both need a reduction across the whole sample (the group
// statistics; K5 then the amax) before anything can be written. The TPU
// kernel held a sample in VMEM; a Hopper SM holds 227 KB of shared memory,
// and a sample is 2.6 MB (64²) to 268 MB (the SD3 VAE at 1024²). Most calls
// are small (66 of the SD1.5 step's 88 at 32² or below), so the fixed
// latency of the reductions weighs as much as the bytes. The design:
//   * one launch of a persistent grid, every block resident (a cooperative
//     launch sized by the occupancy query), the reductions carried by grid
//     barriers (cooperative_groups::this_grid().sync(), so no counter needs
//     a memset); each block owns a contiguous range of one sample's pixels,
//     the same count within one pixel in every block (a barrier waits for
//     the slowest), cut into chunks of R x K pixels (`gn_plan`,
//     `gn_float_plan` in ops/gn_quant.py);
//   * a block is CV x R threads (rounded up to whole warps; the rest idle),
//     CV = C / 8: thread (r, v) holds channels 8v .. 8v + 7 (one 16-byte
//     vector in bf16, two in fp32) of pixels r, r + R, ... of each chunk, so
//     the block's loads of a chunk are one contiguous stretch and each
//     thread's channels never change;
//   * gamma and beta go to shared memory by cp.async at the start, waited
//     for only after the barrier: their memory round trip overlaps phase 1;
//   * phase 1 (`block_stats`, shared by both kernels, so K3's and K5's
//     statistics are the same code) reads each chunk once into registers
//     (K pixels a thread in flight), keeps per thread and channel the mean
//     and M2 (each chunk's own mean and squared deviations, merged by Chan's
//     formula: no E[x²] - E[x]² on the VAE's large-mean activations) and,
//     for K5, the min and max of x. The block's last chunk stays in
//     registers for the pass after the barrier (at the small sites it is the
//     block's only chunk). The block merges its rows and channels into one
//     (count, mean, M2) per group: a segment of S lanes of a warp per group
//     (S the largest power of two <= min(32, threads / G)), each lane taking
//     every S-th of the group's R x C/G parts from shared memory, summed
//     across the segment by warp shuffles (a butterfly: every lane ends with
//     the same bits); first the weighted mean of the parts' means, then the
//     sum of their M2 and n (mean_part - mean)^2. No division per part and
//     no block-wide barrier between the passes. An 8-byte partial (mean,
//     M2) per group to the workspace, and the block's count. Grid barrier;
//   * every block merges its sample's block partials per group
//     (`sample_stats`) the same way: a segment per group, lane l summing
//     blocks l, l + S, ... (kMergeLoads partials in flight, all
//     independent) about block 0's group mean, then the shuffle butterfly
//     (the same bits in every block, and on every run); each thread folds
//     gamma * rstd and the mean into the sc and sh of its own 8 channels;
//   * K3 then writes y = act(x * sc + sh): the kept chunk from registers,
//     the others read again, from L2 where the activation fits there. An
//     activation larger than the L2 (the SD3 VAE at 1024², the DPT-Hybrid
//     stem at batch 16) is read twice from device memory: in channels_last
//     a group is C/G channels of every pixel, 8 bytes of each, and no
//     cheaper route reads a group alone;
//   * K5's phase 2, the amax, reads no value: z is monotone in x within a
//     channel (one FMA, rounded monotonically), so |z| peaks at the
//     channel's min or max of x. SiLU breaks this only below its minimum
//     -0.2785 at z = -1.278, where |SiLU| <= 0.2785: where the block's
//     endpoint amax is at least kSiluFloor, no interior value can exceed
//     it; else the block takes its amax over its values (a pass, rare: an
//     all-but-constant sample). One float per block to the workspace.
//     Barrier;
//   * K5's phase 3 takes the sample's amax over its blocks, the scale once,
//     then the codes of the kept chunk and of the others read again: z,
//     SiLU as z * rcp(1 + 2^(-z log2 e)) (two special-function
//     operations), the quotient z * (1/s) with one FMA correction (equal to
//     __fdiv_rn, quant_common.cuh), rint by the 1.5 * 2^23 shift, four
//     codes packed by byte permutes, 8 bytes stored per thread and pixel.
// Every sum is taken in a fixed order (per thread, then a group's parts in
// lane order and the butterfly, then its sample's blocks likewise), so a
// call repeats bit for bit. Merging the parts by Chan's formula one at a
// time would chain two IEEE divisions per part.
// `quant_tune --part phases` builds this file with -DGN_PHASE_STAMPS and
// reads each phase's cycles per block.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "quant_common.cuh"

namespace cg = cooperative_groups;

// Phase stamps: with -DGN_PHASE_STAMPS, thread 0 of each block adds the
// cycles since its previous stamp to slot i of the phase i that just ended
// (a reduction that waits for no reply, and the previous clock kept in
// shared memory, so a stamp does not stall its warp), and keeps
// %globaltimer (ns) at its first stamp in slot 0 and at its last in slot
// 15; without it, nothing.
#ifdef GN_PHASE_STAMPS
constexpr int kStampBlocks = 8192, kStampSlots = 16;
__device__ unsigned long long g_stamps[kStampBlocks * kStampSlots];
__device__ __forceinline__ long long& stamp_last() {
  __shared__ long long last;  // the block's own
  return last;
}
#define GN_STAMP(i)                                                                  \
  do {                                                                               \
    if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {                             \
      const long long now_ = clock64();                                              \
      unsigned long long* slot_ = g_stamps + blockIdx.x * kStampSlots;               \
      unsigned long long ns_;                                                        \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));                       \
      if ((i) > 0) atomicAdd(slot_ + (i), static_cast<unsigned long long>(now_ - stamp_last())); \
      if ((i) == 0) slot_[0] = ns_;                                                  \
      slot_[kStampSlots - 1] = ns_;                                                  \
      stamp_last() = now_;                                                           \
    }                                                                                \
  } while (0)

// The first n slots (kStampSlots per block), then all of them zeroed.
extern "C" int pd_gn_read_stamps(void* dst, int n) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, g_stamps, sizeof(long long) * n);
  void* slots = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&slots, g_stamps);
  if (err == cudaSuccess) err = cudaMemset(slots, 0, sizeof(g_stamps));
  return static_cast<int>(err);
}
#else
#define GN_STAMP(i) \
  do {              \
  } while (0)
#endif

namespace {

constexpr int kMaxThreads = 512;
constexpr int kWarp = 32;
constexpr int kPix = 8;  // channels of a pixel a thread holds
// > the largest |SiLU(z)| for z <= 0 (0.27846 at z = -1.27846)
constexpr float kSiluFloor = 0.28f;
constexpr float kNegLog2e = -1.4426950408889634f;
constexpr int kMergeLoads = 16;  // block partials a lane loads at once in the sample's merge
enum Act { kNone = 0, kSilu = 1, kRelu = 2 };

struct GnParams {
  const void* x;       // (B, HW, C), dense
  const float* gamma;  // (C,), 16-byte aligned
  const float* beta;   // (C,), 16-byte aligned
  void* out;           // (B, HW, C), dense: K5's int8 codes, K3's y in x's dtype
  float* scales;       // (B,): K5's scale per sample
  float2* parts;       // (B, G, bps) group partials (mean, M2) of the blocks
  float* counts;       // (B * bps,): a group's values in each block
  float* amaxes;       // (B * bps,): K5's block amaxes
  int batch, hw, c, groups;
  int cv, rows;     // threads per pixel (C / 8); pixel rows in flight (threads >= cv * rows)
  int chunks, bps;  // chunks of rows * K pixels per sample; blocks per sample
  float eps;
};

// A thread's 8 channels of a pixel: one 16-byte vector of bf16, two of fp32.
template <typename T>
struct Pix {
  static constexpr int E = Vec<T>::E, N = kPix / E;
  static __device__ __forceinline__ void unpack(const uint4 (&w)[N], float (&f)[kPix]) {
#pragma unroll
    for (int n = 0; n < N; ++n) Vec<T>::unpack(w[n], f + n * E);
  }
  static __device__ __forceinline__ void pack(const float (&f)[kPix], uint4 (&w)[N]) {
#pragma unroll
    for (int n = 0; n < N; ++n) w[n] = Vec<T>::pack(f + n * E);
  }
};

template <int ACT>
__device__ __forceinline__ float epilogue(float z) {
  if constexpr (ACT == kSilu) {
    float e, r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(__fmul_rn(z, kNegLog2e)));
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fadd_rn(1.0f, e)));
    return __fmul_rn(z, r);
  } else if constexpr (ACT == kRelu) {
    return fmaxf(z, 0.0f);
  } else {
    return z;
  }
}

// Float bits as ints that order as the floats do (min and max by integer
// atomics in shared memory: exact, in any order).
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
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

// Lanes of a warp per group in the merges: the largest power of two <=
// min(32, threads / G), at least 1 (`gn_quant.merge_lanes`).
__device__ __forceinline__ int merge_lanes(int groups) {
  const int per = max(1, min(kWarp, static_cast<int>(blockDim.x) / groups));
  return 1 << (31 - __clz(per));
}

// The sum of v over the `seg` lanes of the caller's segment (aligned, a
// power of two), the same bits in each: a butterfly of commutative adds.
// Every lane of the warp calls it.
__device__ __forceinline__ float seg_sum(float v, int seg) {
  for (int off = seg >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory of a block (floats), as `gn_quant.static_smem` counts it:
// gamma and beta (2 C, first: cp.async needs 16-byte alignment), red 2 R C
// (per-row channel means and M2), cmin and cmax C each, nrow R, gstat 2 G,
// wred 32.
__host__ __device__ inline int static_floats(int c, int rows, int groups) {
  return 4 * c + 2 * rows * c + rows + 2 * groups + kWarp;
}

struct Smem {
  float* gb;  // gamma, then beta
  float* red;
  int* cmin;
  int* cmax;
  float* nrow;
  float* gstat;
  float* wred;
};

__device__ __forceinline__ Smem smem_of(float* base, const GnParams& p) {
  Smem s;
  s.gb = base;
  s.red = base + 2 * p.c;
  s.cmin = reinterpret_cast<int*>(s.red + 2 * p.rows * p.c);
  s.cmax = s.cmin + p.c;
  s.nrow = reinterpret_cast<float*>(s.cmax + p.c);
  s.gstat = s.nrow + p.rows;
  s.wred = s.gstat + 2 * p.groups;
  return s;
}

// gamma and beta into shared memory by 16-byte cp.async (C / 4 copies of
// each), not waited for here: `affine_ready` waits after the grid barrier,
// so their round trip overlaps phase 1.
__device__ __forceinline__ void stage_affine(const GnParams& p, const Smem& s) {
  const int n4 = p.c / 4;
  for (int i = threadIdx.x; i < 2 * n4; i += blockDim.x) {
    const float* src = i < n4 ? p.gamma + 4 * i : p.beta + 4 * (i - n4);
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s.gb + 4 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void affine_ready() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// q / d rounded down, for 0 <= q < 2^21 and d >= 1, by a float product:
// (q + 0.5) / d lies >= 0.5 / d from an integer, and the product (with 1/d
// rounded) errs by < (q + 0.5) / d * 2^-23 < 0.5 / d
__device__ __forceinline__ int small_div(int q, float inv_d) {
  return static_cast<int>((static_cast<float>(q) + 0.5f) * inv_d);
}

// Where a block works: pixels [p0, p1) of sample b, j * hw / bps to (j + 1)
// * hw / bps (every block of a sample within one pixel of the same count,
// so none waits long at a barrier for another), cut into `chunks` chunks
// of rows * K pixels from p0; and its thread's pixel row r and channels 8v
// .. 8v + 7.
template <typename T, int K>
struct Tile {
  static constexpr int N = Pix<T>::N;
  const uint4* xs;
  int b, j, p0, p1, chunks, r, v, rows, cv;
  bool active;  // the threads past cv * rows only join the reductions

  __device__ __forceinline__ Tile(const GnParams& p, int b_, int j_) {
    b = b_;
    j = j_;
    p0 = static_cast<int>((int64_t)j * p.hw / p.bps);
    p1 = static_cast<int>((int64_t)(j + 1) * p.hw / p.bps);
    chunks = (p1 - p0 + p.rows * K - 1) / (p.rows * K);
    v = threadIdx.x % p.cv;
    r = threadIdx.x / p.cv;
    rows = p.rows;
    cv = p.cv;
    active = r < rows;
    xs = reinterpret_cast<const uint4*>(static_cast<const T*>(p.x) + (int64_t)b * p.hw * p.c);
  }
  // pixel of row k of chunk ch for this thread
  __device__ __forceinline__ int pixel(int ch, int k) const {
    return p0 + ch * rows * K + k * rows + r;
  }
  // the 16-byte vector n of this thread's channels of pixel px
  __device__ __forceinline__ int64_t vec(int px, int n) const {
    return ((int64_t)px * cv + v) * N + n;
  }
  // how many of its K pixels of chunk ch lie inside the block's range (a prefix)
  __device__ __forceinline__ int valid(int ch) const {
    const int first = pixel(ch, 0);
    return first >= p1 ? 0 : min(K, (p1 - first + rows - 1) / rows);
  }
  __device__ __forceinline__ int load(int ch, uint4 (&raw)[K][N]) const {
    const int kv = active ? valid(ch) : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        raw[k][n] = k < kv ? __ldg(xs + vec(pixel(ch, k), n)) : make_uint4(0, 0, 0, 0);
      }
    }
    return kv;
  }
};

// Phase 1 of block j of sample b: the block's (mean, M2) per group g into
// the workspace at (b, g, j), its count at b * bps + j; with MINMAX (K5)
// also each channel's min and max of x over the block's pixels into cmin
// and cmax. Leaves the block's last chunk in `keep` and returns the
// thread's pixels in it.
template <typename T, int K, bool MINMAX>
__device__ __forceinline__ int block_stats(const GnParams& p, const Smem& s,
                                           const Tile<T, K>& tl,
                                           uint4 (&keep)[K][Pix<T>::N]) {
  const int nt = blockDim.x, t = threadIdx.x;
  const int C = p.c, G = p.groups, CG = C / G, R = p.rows;
  const int r = tl.r, v = tl.v;
  if constexpr (MINMAX) {
    for (int i = t; i < C; i += nt) {
      s.cmin[i] = INT_MAX;
      s.cmax[i] = INT_MIN;
    }
  }
  float n = 0.f, mean[kPix], m2[kPix], lo[kPix], hi[kPix];
#pragma unroll
  for (int e = 0; e < kPix; ++e) {
    mean[e] = m2[e] = 0.f;
    lo[e] = __int_as_float(0x7f800000);
    hi[e] = -lo[e];
  }
  int kept = 0;
  for (int ch = 0; tl.active && ch < tl.chunks; ++ch) {
    const int kv = tl.load(ch, keep);
    kept = kv;
    if (kv == 0) continue;
    float sum[kPix], f[kPix];
#pragma unroll
    for (int e = 0; e < kPix; ++e) sum[e] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kv) {
        Pix<T>::unpack(keep[k], f);
#pragma unroll
        for (int e = 0; e < kPix; ++e) {
          sum[e] += f[e];
          if constexpr (MINMAX) {
            lo[e] = fminf(lo[e], f[e]);
            hi[e] = fmaxf(hi[e], f[e]);
          }
        }
      }
    }
    const float fk = static_cast<float>(kv), inv = __fdiv_rn(1.0f, fk);
    float dev[kPix];
#pragma unroll
    for (int e = 0; e < kPix; ++e) {
      sum[e] *= inv;  // the chunk's mean
      dev[e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kv) {
        Pix<T>::unpack(keep[k], f);
#pragma unroll
        for (int e = 0; e < kPix; ++e) {
          const float d = f[e] - sum[e];
          dev[e] = fmaf(d, d, dev[e]);
        }
      }
    }
    if (n == 0.f) {
#pragma unroll
      for (int e = 0; e < kPix; ++e) {
        mean[e] = sum[e];
        m2[e] = dev[e];
      }
      n = fk;
    } else {
      const float nn = n + fk, w = __fdiv_rn(fk, nn), q = __fdiv_rn(n * fk, nn);
#pragma unroll
      for (int e = 0; e < kPix; ++e) {
        const float delta = sum[e] - mean[e];
        mean[e] = fmaf(delta, w, mean[e]);
        m2[e] = m2[e] + dev[e] + delta * delta * q;
      }
      n = nn;
    }
  }
  if constexpr (MINMAX) __syncthreads();  // cmin and cmax set before the atomics
  float* red = s.red;
  if (tl.active) {
#pragma unroll
    for (int e = 0; e < kPix; ++e) {
      red[r * C + v * kPix + e] = mean[e];
      red[(R + r) * C + v * kPix + e] = m2[e];
      if (MINMAX && n > 0.f) {
        atomicMin(s.cmin + v * kPix + e, ordered(lo[e]));
        atomicMax(s.cmax + v * kPix + e, ordered(hi[e]));
      }
    }
    if (v == 0) s.nrow[r] = n;
  }
  __syncthreads();
  GN_STAMP(1);
  // the block's R x CG parts of each group (a row's parts share its count
  // n_r), part i = (row i / CG, channel i % CG of the group): the weighted
  // mean of their means, then the sum of their M2 and n_r (mean_part -
  // mean)^2, each a pass of lane sums over a segment of S lanes (lane l
  // takes parts l, l + S, ...: neighbouring lanes read neighbouring
  // channels) and the shuffle butterfly
  const int seg = merge_lanes(G), lane = t & (seg - 1), nseg = nt / seg;
  const int parts = R * CG;
  const float inv_cg = __frcp_rn(static_cast<float>(CG));
  const float cnt = static_cast<float>(tl.p1 - tl.p0) * CG, inv_cnt = __fdiv_rn(1.0f, cnt);
  float2* part = p.parts + (int64_t)tl.b * G * p.bps + tl.j;
  if (t == 0) p.counts[(int64_t)tl.b * p.bps + tl.j] = cnt;
  for (int g0 = 0; g0 < G; g0 += nseg) {  // the same trip count in every thread
    const int g = g0 + t / seg;
    const bool live = g < G;
    const int base = (live ? g : 0) * CG;
    float s1 = 0.f;
    for (int i = lane; live && i < parts; i += seg) {
      const int rr = small_div(i, inv_cg);
      s1 = fmaf(s.nrow[rr], red[rr * C + base + i - rr * CG], s1);
    }
    const float gm = seg_sum(s1, seg) * inv_cnt;
    float q = 0.f;
    for (int i = lane; live && i < parts; i += seg) {
      const int rr = small_div(i, inv_cg), c = base + i - rr * CG;
      const float d = red[rr * C + c] - gm;  // a row without pixels holds 0, 0
      q += fmaf(s.nrow[rr] * d, d, red[(R + rr) * C + c]);
    }
    q = seg_sum(q, seg);
    if (live && lane == 0) part[(int64_t)g * p.bps] = make_float2(gm, q);
  }
  GN_STAMP(2);
  return kept;
}

// After the barrier: sample b's group statistics from its blocks'
// partials, a segment of S lanes per group, lane l summing blocks l, l + S,
// ... of group g about a shift, block 0's group mean (the same in every
// lane; the blocks' means lie within a few standard errors of it, so the
// shifted sums lose nothing to cancellation), all loads of a lane
// independent; then the shuffle butterfly. Every block of the sample reads
// all its partials at once (at the SD3 VAE, 264 blocks each read 264 x 32),
// so they are 8 bytes (a block's count is one float for all groups), a
// group's blocks lie side by side (a segment's loads are one stretch), and
// they go through L1, which the blocks on an SM share. Leaves each group's
// mean and rstd in gstat, gamma and beta ready.
__device__ __forceinline__ void sample_stats(const GnParams& p, const Smem& s, int b) {
  const int nt = blockDim.x, t = threadIdx.x, G = p.groups;
  const float2* parts = p.parts + (int64_t)b * G * p.bps;
  const float* counts = p.counts + (int64_t)b * p.bps;
  const int seg = merge_lanes(G), lane = t & (seg - 1), nseg = nt / seg;
  for (int g0 = 0; g0 < G; g0 += nseg) {  // the same trip count in every thread
    const int g = g0 + t / seg;
    const bool live = g < G;
    const int gg = live ? g : 0;
    const float2* mine = parts + (int64_t)gg * p.bps;
    const float shift = mine[0].x;
    float n = 0.f, s1 = 0.f, s2 = 0.f;
    for (int j0 = lane; live && j0 < p.bps; j0 += kMergeLoads * seg) {
      float2 q[kMergeLoads];
      float w[kMergeLoads];
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        const int jj = min(j0 + u * seg, p.bps - 1);
        q[u] = mine[jj];
        w[u] = counts[jj];
      }
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        if (j0 + u * seg < p.bps) {
          const float d = q[u].x - shift;
          n += w[u];
          s1 = fmaf(w[u], d, s1);
          s2 += fmaf(w[u] * d, d, q[u].y);
        }
      }
    }
    n = seg_sum(n, seg);
    s1 = seg_sum(s1, seg);
    s2 = seg_sum(s2, seg);
    if (live && lane == 0) {
      const float d = __fdiv_rn(s1, n);  // the group mean less the shift
      s.gstat[2 * g] = shift + d;
      s.gstat[2 * g + 1] = rsqrtf(__fdiv_rn(fmaf(-s1, d, s2), n) + p.eps);
    }
  }
  affine_ready();
}

// sc = gamma * rstd and sh = beta - mean * sc of the thread's channels 8v
// .. 8v + 7
__device__ __forceinline__ void coefficients(const GnParams& p, const Smem& s, int v,
                                             float (&sc)[kPix], float (&sh)[kPix]) {
  const float inv_cg = __frcp_rn(static_cast<float>(p.c / p.groups));
#pragma unroll
  for (int e = 0; e < kPix; ++e) {
    const int c = v * kPix + e, g = small_div(c, inv_cg);
    sc[e] = s.gb[c] * s.gstat[2 * g + 1];
    sh[e] = fmaf(-s.gstat[2 * g], sc[e], s.gb[p.c + c]);
  }
}

// K3's output of chunk ch (the thread's kv pixels of it, held in raw)
template <typename T, int K, int ACT>
__device__ __forceinline__ void store_y(const Tile<T, K>& tl, uint4* out, int ch,
                                        const uint4 (&raw)[K][Pix<T>::N], int kv,
                                        const float (&sc)[kPix], const float (&sh)[kPix]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < kv) {
      float f[kPix];
      uint4 w[Pix<T>::N];
      Pix<T>::unpack(raw[k], f);
#pragma unroll
      for (int e = 0; e < kPix; ++e) f[e] = epilogue<ACT>(fmaf(f[e], sc[e], sh[e]));
      Pix<T>::pack(f, w);
#pragma unroll
      for (int n = 0; n < Pix<T>::N; ++n) out[tl.vec(tl.pixel(ch, k), n)] = w[n];
    }
  }
}

// K5's codes of chunk ch
template <typename T, int K, int ACT>
__device__ __forceinline__ void store_codes(const Tile<T, K>& tl, int8_t* out, int ch,
                                            const uint4 (&raw)[K][Pix<T>::N], int kv,
                                            const float (&sc)[kPix], const float (&sh)[kPix],
                                            float sa, float rs) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < kv) {
      float f[kPix];
      Pix<T>::unpack(raw[k], f);
      uint32_t w[kPix / 4];
#pragma unroll
      for (int h = 0; h < kPix / 4; ++h) {
        uint32_t code[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * h + i;
          const float z = epilogue<ACT>(fmaf(f[e], sc[e], sh[e]));
          code[i] = rq::code_bits(rq::quotient(z, sa, rs));
        }
        w[h] = rq::pack4(code[0], code[1], code[2], code[3]);
      }
      *reinterpret_cast<uint2*>(out + (int64_t)tl.pixel(ch, k) * tl.cv * kPix) =
          make_uint2(w[0], w[1]);
    }
  }
}

template <typename T, int K, bool SILU>
__global__ void __launch_bounds__(kMaxThreads) gn_quant_kernel(const GnParams p) {
  constexpr int ACT = SILU ? kSilu : kNone;
  extern __shared__ float4 smem4[];
  const Smem s = smem_of(reinterpret_cast<float*>(smem4), p);
  const int nt = blockDim.x, t = threadIdx.x;
  GN_STAMP(0);
  const int blk = blockIdx.x, b = blk / p.bps, j = blk % p.bps;
  const Tile<T, K> tl(p, b, j);
  stage_affine(p, s);
  uint4 keep[K][Pix<T>::N];
  const int kept = block_stats<T, K, true>(p, s, tl, keep);
  cg::this_grid().sync();
  GN_STAMP(3);
  sample_stats(p, s, b);
  float csc[kPix], csh[kPix];  // an idle thread's v is a real channel group
  coefficients(p, s, tl.v, csc, csh);
  GN_STAMP(4);

  // ---- phase 2: the block's amax from each channel's min and max of x,
  // the channels of row 0's threads
  float amax = 0.f;
  if (t < p.cv) {
#pragma unroll
    for (int e = 0; e < kPix; ++e) {
      const int c = tl.v * kPix + e;
      const float zl = epilogue<ACT>(fmaf(unordered(s.cmin[c]), csc[e], csh[e]));
      const float zh = epilogue<ACT>(fmaf(unordered(s.cmax[c]), csc[e], csh[e]));
      amax = fmaxf(amax, fmaxf(fabsf(zl), fabsf(zh)));
    }
  }
  amax = block_max(amax, s.wred);
  if (SILU && amax < kSiluFloor) {  // a SiLU minimum may lie inside a channel's range
    amax = 0.f;
    for (int ch = 0; ch < tl.chunks; ++ch) {
      uint4 raw[K][Pix<T>::N];
      const int kv = tl.load(ch, raw);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < kv) {
          float f[kPix];
          Pix<T>::unpack(raw[k], f);
#pragma unroll
          for (int e = 0; e < kPix; ++e) {
            amax = fmaxf(amax, fabsf(epilogue<ACT>(fmaf(f[e], csc[e], csh[e]))));
          }
        }
      }
    }
    amax = block_max(amax, s.wred);
  }
  if (t == 0) p.amaxes[blk] = amax;
  GN_STAMP(5);
  cg::this_grid().sync();
  GN_STAMP(6);

  // ---- phase 3: the sample's scale, then the codes
  float m = 0.f;
  for (int jj = t; jj < p.bps; jj += nt) m = fmaxf(m, p.amaxes[b * p.bps + jj]);
  m = block_max(m, s.wred);
  const float sa = fmaxf(__fdiv_rn(m, 127.f), 1e-8f);
  const float rs = __frcp_rn(sa);
  if (j == 0 && t == 0) p.scales[b] = sa;
  GN_STAMP(7);
  int8_t* out = static_cast<int8_t*>(p.out) + (int64_t)b * p.hw * p.c + tl.v * kPix;
  if (tl.active) {
    store_codes<T, K, ACT>(tl, out, tl.chunks - 1, keep, kept, csc, csh, sa, rs);
    for (int ch = 0; ch < tl.chunks - 1; ++ch) {
      uint4 raw[K][Pix<T>::N];
      const int kv = tl.load(ch, raw);
      store_codes<T, K, ACT>(tl, out, ch, raw, kv, csc, csh, sa, rs);
    }
  }
  GN_STAMP(8);
}

// K3: phase 1, one barrier, the sample's statistics, then the output.
template <typename T, int K, int ACT>
__global__ void __launch_bounds__(kMaxThreads) gn_float_kernel(const GnParams p) {
  extern __shared__ float4 smem4[];
  const Smem s = smem_of(reinterpret_cast<float*>(smem4), p);
  GN_STAMP(0);
  const int b = blockIdx.x / p.bps, j = blockIdx.x % p.bps;
  const Tile<T, K> tl(p, b, j);
  stage_affine(p, s);
  uint4 keep[K][Pix<T>::N];
  const int kept = block_stats<T, K, false>(p, s, tl, keep);
  cg::this_grid().sync();
  GN_STAMP(3);
  sample_stats(p, s, b);
  float csc[kPix], csh[kPix];
  coefficients(p, s, tl.v, csc, csh);
  GN_STAMP(4);
  uint4* out = reinterpret_cast<uint4*>(static_cast<T*>(p.out) + (int64_t)b * p.hw * p.c);
  if (tl.active) {
    store_y<T, K, ACT>(tl, out, tl.chunks - 1, keep, kept, csc, csh);
    for (int ch = 0; ch < tl.chunks - 1; ++ch) {
      uint4 raw[K][Pix<T>::N];
      const int kv = tl.load(ch, raw);
      store_y<T, K, ACT>(tl, out, ch, raw, kv, csc, csh);
    }
  }
  GN_STAMP(5);
}

template <typename T, int K, bool SILU>
void* quant_kernel_of() {
  return reinterpret_cast<void*>(gn_quant_kernel<T, K, SILU>);
}

template <typename T, int K, int ACT>
void* float_kernel_of() {
  return reinterpret_cast<void*>(gn_float_kernel<T, K, ACT>);
}

// K5's kernel <bf16 or fp32, k, silu>, or nullptr; K = 8 in bf16 only (the
// 8 pixels' 16 vectors of fp32 would not fit the registers)
void* pick_quant(int x_bf16, int k, int silu) {
#define PD_GN_PICK(T)                                                                     \
  case 1: return silu ? quant_kernel_of<T, 1, true>() : quant_kernel_of<T, 1, false>();   \
  case 2: return silu ? quant_kernel_of<T, 2, true>() : quant_kernel_of<T, 2, false>();   \
  case 4: return silu ? quant_kernel_of<T, 4, true>() : quant_kernel_of<T, 4, false>();
  if (x_bf16) {
    switch (k) {
      PD_GN_PICK(__nv_bfloat16)
      case 8: return silu ? quant_kernel_of<__nv_bfloat16, 8, true>()
                          : quant_kernel_of<__nv_bfloat16, 8, false>();
      default: return nullptr;
    }
  }
  switch (k) {
    PD_GN_PICK(float)
    default: return nullptr;
  }
#undef PD_GN_PICK
}

template <typename T, int K>
void* pick_act(int act) {
  switch (act) {
    case kNone: return float_kernel_of<T, K, kNone>();
    case kSilu: return float_kernel_of<T, K, kSilu>();
    case kRelu: return float_kernel_of<T, K, kRelu>();
    default: return nullptr;
  }
}

// K3's kernel <bf16 or fp32, k, act>, or nullptr; K as K5's
void* pick_float(int x_bf16, int k, int act) {
#define PD_GN_PICK(T)                 \
  case 1: return pick_act<T, 1>(act); \
  case 2: return pick_act<T, 2>(act); \
  case 4: return pick_act<T, 4>(act);
  if (x_bf16) {
    switch (k) {
      PD_GN_PICK(__nv_bfloat16)
      case 8: return pick_act<__nv_bfloat16, 8>(act);
      default: return nullptr;
    }
  }
  switch (k) {
    PD_GN_PICK(float)
    default: return nullptr;
  }
#undef PD_GN_PICK
}

// Lets the kernel take all of an SM's shared memory a block may have, less
// its static shared memory (the phase stamps' clock, when built with them).
cudaError_t allow_smem(void* kernel) {
  int dev = 0, most = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most - static_cast<int>(attr.sharedSizeBytes));
  }
  return err;
}

int occupancy(void* kernel, int threads, int smem) {
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

// The checks both launchers make of a plan, and the parameters.
bool fill(GnParams& p, const void* x, const void* gamma, const void* beta, void* out, void* ws,
          int batch, int hw, int c, int groups, float eps, int k, int rows, int threads,
          int chunks, int bps) {
  const int cv = c / kPix;
  if (batch < 1 || hw < 1 || c < 1 || c % kPix != 0 || groups < 1 || c % groups != 0 ||
      rows < 1 || threads < cv * rows || threads % kWarp != 0 || threads > kMaxThreads ||
      chunks < 1 || (int64_t)chunks * rows * k < hw || bps < 1 || bps > chunks ||
      (int64_t)batch * bps > INT_MAX || reinterpret_cast<uintptr_t>(gamma) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(beta) % 16 != 0) {
    return false;
  }
  p.x = x;
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.out = out;
  p.scales = nullptr;
  p.parts = static_cast<float2*>(ws);
  p.counts = static_cast<float*>(ws) + (int64_t)batch * bps * groups * 2;
  p.amaxes = p.counts + (int64_t)batch * bps;
  p.batch = batch;
  p.hw = hw;
  p.c = c;
  p.groups = groups;
  p.cv = cv;
  p.rows = rows;
  p.chunks = chunks;
  p.bps = bps;
  p.eps = eps;
  return true;
}

int launch(void* kernel, GnParams& p, int threads, void* stream) {
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  const size_t smem = sizeof(float) * static_floats(p.c, p.rows, p.groups);
  err = cudaLaunchCooperativeKernel(kernel, dim3(p.batch * p.bps), dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // namespace

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory that
// one SM holds at once for K5's kernel <bf16 or fp32, k, silu>; negative: a
// CUDA error.
extern "C" int pd_gn_quant_occupancy(int x_bf16, int k, int silu, int threads, int smem) {
  return occupancy(pick_quant(x_bf16, k, silu), threads, smem);
}

// The same for K3's kernel <bf16 or fp32, k, act> (0 none, 1 SiLU, 2 ReLU).
extern "C" int pd_gn_float_occupancy(int x_bf16, int k, int act, int threads, int smem) {
  return occupancy(pick_float(x_bf16, k, act), threads, smem);
}

// K5 on `stream`: returns the launch's cudaError_t (0 = queued). x: `batch`
// samples of hw pixels of c values (bf16 if x_bf16, else fp32), dense,
// 16-byte aligned; gamma and beta fp32 (c,), 16-byte aligned; codes (batch,
// hw, c) int8 and scales (batch,) fp32; ws: batch * bps * (2 groups + 2)
// floats. The plan (pixels per thread and chunk k, pixel rows, threads per
// block, chunks per sample, blocks per sample) comes from `gn_plan`; its
// grid of batch * bps blocks must be resident at once (the cooperative
// launch refuses it otherwise).
extern "C" int pd_gn_quant(const void* x, int x_bf16, const void* gamma, const void* beta,
                           void* codes, void* scales, void* ws, int batch, int hw, int c,
                           int groups, float eps, int silu, int k, int rows, int threads,
                           int chunks, int bps, void* stream) {
  void* kernel = pick_quant(x_bf16, k, silu);
  GnParams p;
  if (kernel == nullptr || !fill(p, x, gamma, beta, codes, ws, batch, hw, c, groups, eps, k,
                                 rows, threads, chunks, bps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.scales = static_cast<float*>(scales);
  return launch(kernel, p, threads, stream);
}

// K3 on `stream`: returns the launch's cudaError_t (0 = queued). x, gamma
// and beta as K5's; y (batch, hw, c) in x's dtype; act 0 none, 1 SiLU, 2
// ReLU; ws: batch * bps * (2 groups + 1) floats. The plan comes from
// `gn_float_plan`; its grid of batch * bps blocks must be resident at once
// (the cooperative launch refuses it otherwise).
extern "C" int pd_gn_float(const void* x, int x_bf16, const void* gamma, const void* beta,
                           void* y, void* ws, int batch, int hw, int c, int groups, float eps,
                           int act, int k, int rows, int threads, int chunks, int bps,
                           void* stream) {
  void* kernel = pick_float(x_bf16, k, act);
  GnParams p;
  if (kernel == nullptr || !fill(p, x, gamma, beta, y, ws, batch, hw, c, groups, eps, k, rows,
                                 threads, chunks, bps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(kernel, p, threads, stream);
}
