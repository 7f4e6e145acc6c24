// int8 SAME 3x3 stride-1 convolution for Hopper (sm_90a), NHWC.
//
// Replaces the TPU kernel prompt_diffusion_tpu/ops/int8_conv.py::
// conv3x3_int8 in both of its variants: `_conv_kernel` ("im2col", the
// default) and `_conv_kernel_xshift` ("xshift"). They serve the 3x3 convs
// of the int8 W8A8 serving mode (ResBlock in/out convs, Upsample, the
// latent input conv, the int8 VAE) and compute one function:
//
//   out[b, y, x, n] = bf16|f32( fma(f32(acc), s_a[b] * s_w[n], bias[n]) )
//   acc             = sum over (dy, dx, ci) of
//                     xq[b, y+dy-1, x+dx-1, ci] * wq[n, dy, dx, ci]   (int32)
//
// The int32 sum is exact. The epilogue rounds s_a*s_w first (__fmul_rn),
// then acc*scale + bias once, as one fused multiply-add (__fmaf_rn), as the
// JAX package's kernel and its XLA path compute it on the CPU, then to
// bf16 to nearest even. The explicit intrinsics fix where nvcc rounds, and
// both kernels equal the plain PyTorch versions (int8 im2col or nine
// shifted per-tap products, torch._int_mm, the same epilogue) bit for bit.
//
// What bounds them: at the SD1.5 512^2 shapes these convs are the largest
// matrix products of the step (K = 9*Cin = 2880..23040), so both are
// implicit GEMMs on the tensor cores, M = B*H*W output pixels, N = Cout,
// one block of 8 warps per 128-pixel x 64-channel output tile, int32
// accumulators, and the accumulators through shared memory to the fp32
// epilogue, whose stores are coalesced along Cout. They differ in how the
// A operand reaches the tensor cores:
//   * "im2col" (`conv3x3_int8_kernel`): the block walks K in slices of 32
//     and gathers each slice of the im2col rows straight from the NHWC
//     activation in device memory (no im2col in device memory, but every
//     input pixel is read up to nine times, once per tap, through L2);
//     WMMA s8 16x16x16. With Cin % 16 == 0 a 16-byte load never crosses a
//     tap, so every load is one int4; the SAME padding and the tails in M,
//     N and K are zero-filled in the gather. Other Cin (the 4-channel
//     latent input conv) take a byte-wise gather;
//   * "xshift" (`conv3x3_int8_xshift_kernel`), the TPU variant's idea: per
//     32-channel slice of Cin the block stages the raw input rows its
//     pixels touch ONCE in shared memory, with their one-pixel halo
//     ((rows + 2) x (W + 2) pixels, or 3 x 130 when a row is wider than
//     the tile), the SAME padding zero-filled while staging, beside the
//     slice of all nine taps' weights; then it runs the nine taps as
//     shifted products over that tile, K = 32 each. A shifted view moves a
//     row by 32 bytes, which breaks WMMA's 256-bit fragment alignment, so
//     the products are `mma.sync` m16n8k32 s8 fed by `ldmatrix`, which
//     takes one 16-byte aligned address per row: each lane points at its
//     pixel's staged slot for the tap, or at a zero slot where the tap
//     falls outside the pixel's own image. A tile spans several image rows
//     and, at the 8x8 latents, several images. Activation traffic is one
//     read of each staged pixel per block instead of nine. Cin = 4 is
//     staged zero-padded to the 32-wide slice.
// Speed work (cp.async/TMA pipelining, wgmma, larger tiles, split-K for
// the 8x8 shapes) is left to later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // reduction slice per step
constexpr int NWARPS = 8;  // 4 (M) x 2 (N) warps of 32x32
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDC = BN + 4;  // int32 pitch of the accumulator tile

struct Params {
  const int8_t* x;     // (B, H, W, Cin)
  const int8_t* wt;    // (Cout, 3, 3, Cin)
  const float* s_a;    // (B,)
  const float* s_w;    // (Cout,)
  const float* bias;   // (Cout,) or null
  void* out;           // (B, H, W, Cout), bf16 or f32
  int h, wd, cin, cout, k_total;
  int64_t m_total;
  int out_bf16;
};

// One int8 of the implicit im2col row of pixel m at reduction index k.
__device__ __forceinline__ int8_t gather_a(const Params& p, int64_t m, int k) {
  if (m >= p.m_total || k >= p.k_total) return 0;
  const int hw = p.h * p.wd;
  const int b = static_cast<int>(m / hw);
  const int r = static_cast<int>(m - static_cast<int64_t>(b) * hw);
  const int y = r / p.wd, x = r - y * p.wd;
  const int tap = k / p.cin, ci = k - tap * p.cin;
  const int iy = y + tap / 3 - 1, ix = x + tap % 3 - 1;
  if (iy < 0 || iy >= p.h || ix < 0 || ix >= p.wd) return 0;
  return p.x[((static_cast<int64_t>(b) * p.h + iy) * p.wd + ix) * p.cin + ci];
}

// Shared tiles are stored as [BK / 16][rows][16]: each 16x16 fragment is
// 256 contiguous bytes (ldm 16, 256-bit aligned, as WMMA requires).
template <bool VEC>
__device__ __forceinline__ void load_tiles(const Params& p, int8_t* sA, int8_t* sB,
                                           int64_t m0, int n0, int k0, int tid) {
  const int row = tid >> 1, half = tid & 1;
  const int k = k0 + half * 16;
  {  // A: 128 rows x 2 chunks of 16 bytes, one chunk per thread
    const int64_t m = m0 + row;
    int8_t* dst = sA + half * BM * 16 + row * 16;
    if (VEC) {
      int4 v = make_int4(0, 0, 0, 0);
      if (m < p.m_total && k < p.k_total) {
        const int hw = p.h * p.wd;
        const int b = static_cast<int>(m / hw);
        const int r = static_cast<int>(m - static_cast<int64_t>(b) * hw);
        const int y = r / p.wd, x = r - y * p.wd;
        const int tap = k / p.cin, ci = k - tap * p.cin;
        const int iy = y + tap / 3 - 1, ix = x + tap % 3 - 1;
        if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.wd) {
          v = *reinterpret_cast<const int4*>(
              p.x + ((static_cast<int64_t>(b) * p.h + iy) * p.wd + ix) * p.cin + ci);
        }
      }
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      for (int j = 0; j < 16; ++j) dst[j] = gather_a(p, m, k + j);
    }
  }
  if (row < BN) {  // B: 64 rows (output channels) x 2 chunks
    const int n = n0 + row;
    int8_t* dst = sB + half * BN * 16 + row * 16;
    const int8_t* src = p.wt + static_cast<int64_t>(n) * p.k_total + k;
    if (VEC) {
      int4 v = make_int4(0, 0, 0, 0);
      if (n < p.cout && k < p.k_total) v = *reinterpret_cast<const int4*>(src);
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      for (int j = 0; j < 16; ++j) {
        dst[j] = (n < p.cout && k + j < p.k_total) ? src[j] : static_cast<int8_t>(0);
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS) conv3x3_int8_kernel(Params p) {
  __shared__ __align__(128) int8_t sA[BK / 16 * BM * 16];
  __shared__ __align__(128) int8_t sB[BK / 16 * BN * 16];
  __shared__ __align__(128) int32_t sC[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // warp tile (wm*32, wn*32)
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < p.k_total; k0 += BK) {
    load_tiles<VEC>(p, sA, sB, m0, n0, k0, tid);
    __syncthreads();
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(
            a[i], reinterpret_cast<const signed char*>(sA + kk * BM * 16 + (wm * 32 + i * 16) * 16),
            16);
      }
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(
            b[j], reinterpret_cast<const signed char*>(sB + kk * BN * 16 + (wn * 32 + j * 16) * 16),
            16);
      }
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  const int hw = p.h * p.wd;
  for (int e = tid; e < BM * BN; e += NTHREADS) {
    const int r = e / BN, c = e - (e / BN) * BN;
    const int64_t m = m0 + r;
    const int n = n0 + c;
    if (m >= p.m_total || n >= p.cout) continue;
    const int b = static_cast<int>(m / hw);
    const float scale = __fmul_rn(p.s_a[b], p.s_w[n]);
    const float a = __int2float_rn(sC[r * LDC + c]);
    const float v = p.bias != nullptr ? __fmaf_rn(a, scale, p.bias[n]) : __fmul_rn(a, scale);
    const int64_t o = m * p.cout + n;
    if (p.out_bf16) {
      static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
    } else {
      static_cast<float*>(p.out)[o] = v;
    }
  }
}


// ---- the xshift variant -------------------------------------------------

constexpr int XS_SLOT = 48;  // bytes per staged pixel: the 32-byte Cin slice
                             // + 16 of pad, so ldmatrix rows hit distinct banks
constexpr int XS_WIDE = BM;  // rows wider than this are tiled in x

struct XsParams {
  Params p;
  int wide;    // W > XS_WIDE: a tile is 128 pixels of one row
  int xtiles;  // tiles per row when wide
  int slots;   // staged pixel slots, the last one all zeros
};

__host__ __device__ inline size_t xs_align128(size_t n) { return (n + 127) / 128 * 128; }

// staged pixel slots a block may need, plus the zero slot
__host__ inline int xs_slots(int wd) {
  if (wd > XS_WIDE) return 3 * (XS_WIDE + 2) + 1;
  return ((wd + BM - 2) / wd + 3) * (wd + 2) + 1;
}

__host__ inline size_t xs_smem(int slots) {
  const size_t stage = xs_align128((size_t)slots * XS_SLOT) + (size_t)9 * BN * XS_SLOT;
  const size_t epi = (size_t)BM * LDC * 4;
  return stage > epi ? stage : epi;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16x32, row-major) * b (32x8, column-major), int8 into int32
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of `src` (chunk of a channel slice starting at channel c) into
// `dst`; channels past cin, and `ok == false`, give zeros.
template <bool VEC>
__device__ __forceinline__ void stage16(int8_t* dst, const int8_t* src, bool ok, int c, int cin) {
  if (VEC) {
    int4 v = make_int4(0, 0, 0, 0);
    if (ok && c < cin) v = *reinterpret_cast<const int4*>(src);
    *reinterpret_cast<int4*>(dst) = v;
  } else {
    for (int j = 0; j < 16; ++j) dst[j] = (ok && c + j < cin) ? src[j] : static_cast<int8_t>(0);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS) conv3x3_int8_xshift_kernel(XsParams xp) {
  const Params& p = xp.p;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sX = reinterpret_cast<int8_t*>(smem);  // staged pixels, XS_SLOT bytes each
  int8_t* sW = sX + xs_align128((size_t)xp.slots * XS_SLOT);  // [9][BN][XS_SLOT]
  int32_t* sC = reinterpret_cast<int32_t*>(smem);  // the accumulators, after the loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // warp tile (wm*32, wn*32)
  const int n0 = blockIdx.y * BN;
  const int rows_total = static_cast<int>(p.m_total / p.wd);  // B*H image rows

  // the tile: 128 positions t, each an output pixel (row g, column x) or none
  int64_t m0 = 0;
  int g_first, g_last, x_lo, x_hi;
  if (!xp.wide) {
    m0 = static_cast<int64_t>(blockIdx.x) * BM;
    const int64_t m_last = (m0 + BM < p.m_total ? m0 + BM : p.m_total) - 1;
    g_first = static_cast<int>(m0 / p.wd);
    g_last = static_cast<int>(m_last / p.wd);
    x_lo = 0;
    x_hi = p.wd - 1;
  } else {
    g_first = g_last = blockIdx.x / xp.xtiles;
    x_lo = (blockIdx.x % xp.xtiles) * BM;
    x_hi = (x_lo + BM < p.wd ? x_lo + BM : p.wd) - 1;
  }
  const int gs = g_first - 1, xs = x_lo - 1;  // staged origin (with the halo)
  const int nr = g_last - g_first + 3, nc = x_hi - x_lo + 3;
  const int zero_slot = xp.slots - 1;

  // This lane's ldmatrix rows: for each of its two 16-row A fragments, the
  // centre slot of the pixel and which of the nine taps stay in its image.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int akoff = (lane >> 4) * 16;
  int centre[2];
  unsigned taps[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = wm * 32 + i * 16 + arow;
    int g, x;
    bool valid;
    if (!xp.wide) {
      const int64_t m = m0 + t;
      valid = m < p.m_total;
      g = static_cast<int>(m / p.wd);
      x = static_cast<int>(m - static_cast<int64_t>(g) * p.wd);
    } else {
      g = g_first;
      x = x_lo + t;
      valid = x < p.wd;
    }
    const int y = g % p.h;
    centre[i] = (g - gs) * nc + (x - xs);
    unsigned mask = 0;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const int iy = y + dy - 1, ix = x + dx - 1;
        if (valid && iy >= 0 && iy < p.h && ix >= 0 && ix < p.wd) mask |= 1u << (dy * 3 + dx);
      }
    }
    taps[i] = mask;
  }
  // B rows: two n8 blocks per ldmatrix.x4 (k 0-15 and 16-31 of each)
  const int brow = (lane & 7) + (lane >> 4) * 8;
  const int bkoff = ((lane >> 3) & 1) * 16;

  if (tid < XS_SLOT / 16) {
    *reinterpret_cast<int4*>(sX + zero_slot * XS_SLOT + tid * 16) = make_int4(0, 0, 0, 0);
  }

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int c0 = 0; c0 < p.cin; c0 += BK) {
    __syncthreads();  // the previous slice's readers are done
    // the raw input rows of the tile with their halo, this channel slice
    for (int i = tid; i < nr * nc * 2; i += NTHREADS) {
      const int s = i >> 1, half = i & 1;
      const int rr = s / nc, cc = s - rr * nc;
      const int gg = gs + rr, xx = xs + cc;
      const int c = c0 + half * 16;
      const bool ok = gg >= 0 && gg < rows_total && xx >= 0 && xx < p.wd;
      const int8_t* src = ok ? p.x + (static_cast<int64_t>(gg) * p.wd + xx) * p.cin + c : p.x;
      stage16<VEC>(sX + s * XS_SLOT + half * 16, src, ok, c, p.cin);
    }
    // the nine taps' weights of this slice, [tap][n][32]
    for (int i = tid; i < 9 * BN * 2; i += NTHREADS) {
      const int tap = i / (BN * 2), rem = i - tap * (BN * 2);
      const int n = rem >> 1, half = rem & 1;
      const int c = c0 + half * 16;
      const bool ok = n0 + n < p.cout;
      const int8_t* src =
          ok ? p.wt + static_cast<int64_t>(n0 + n) * p.k_total + tap * p.cin + c : p.wt;
      stage16<VEC>(sW + (tap * BN + n) * XS_SLOT + half * 16, src, ok, c, p.cin);
    }
    __syncthreads();

    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3 - 1) * nc + (tap % 3 - 1);
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int slot = (taps[i] >> tap) & 1u ? centre[i] + shift : zero_slot;
        ldmatrix_x4(a[i], sX + slot * XS_SLOT + akoff);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, sW + (tap * BN + wn * 32 + j * 16 + brow) * XS_SLOT + bkoff);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8(acc[i][2 * j], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();  // the staged tiles are dead; sC reuses their memory

  // m16n8 accumulator layout: c0, c1 at (row g, cols 2q, 2q+1), c2, c3 at
  // row g + 8, with g = lane / 4, q = lane % 4
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = wm * 32 + i * 16 + (lane >> 2);
      const int col = wn * 32 + j * 8 + (lane & 3) * 2;
      sC[row * LDC + col] = acc[i][j][0];
      sC[row * LDC + col + 1] = acc[i][j][1];
      sC[(row + 8) * LDC + col] = acc[i][j][2];
      sC[(row + 8) * LDC + col + 1] = acc[i][j][3];
    }
  }
  __syncthreads();

  const int hw = p.h * p.wd;
  for (int e = tid; e < BM * BN; e += NTHREADS) {
    const int r = e / BN, c = e - (e / BN) * BN;
    int64_t m;
    if (!xp.wide) {
      m = m0 + r;
      if (m >= p.m_total) continue;
    } else {
      if (x_lo + r >= p.wd) continue;
      m = static_cast<int64_t>(g_first) * p.wd + x_lo + r;
    }
    const int n = n0 + c;
    if (n >= p.cout) continue;
    const int b = static_cast<int>(m / hw);
    const float scale = __fmul_rn(p.s_a[b], p.s_w[n]);
    const float a = __int2float_rn(sC[r * LDC + c]);
    const float v = p.bias != nullptr ? __fmaf_rn(a, scale, p.bias[n]) : __fmul_rn(a, scale);
    const int64_t o = m * p.cout + n;
    if (p.out_bf16) {
      static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
    } else {
      static_cast<float*>(p.out)[o] = v;
    }
  }
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// `vec` (Cin % 16 == 0 and 16-byte aligned x and w) selects 16-byte loads.
extern "C" int pd_conv3x3_int8(const void* x, const void* w, const void* s_a,
                               const void* s_w, const void* bias, void* out,
                               int batch, int h, int wd, int cin, int cout,
                               int out_bf16, int vec, void* stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 ||
      (cout + BN - 1) / BN > 65535 || static_cast<int64_t>(9) * cin > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(w);
  p.s_a = static_cast<const float*>(s_a);
  p.s_w = static_cast<const float*>(s_w);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.h = h; p.wd = wd; p.cin = cin; p.cout = cout;
  p.k_total = 9 * cin;
  p.m_total = static_cast<int64_t>(batch) * h * wd;
  p.out_bf16 = out_bf16;
  const int64_t m_blocks = (p.m_total + BM - 1) / BM;
  if (m_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(m_blocks), (cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    conv3x3_int8_kernel<true><<<grid, NTHREADS, 0, s>>>(p);
  } else {
    conv3x3_int8_kernel<false><<<grid, NTHREADS, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The xshift variant; the same arguments and result.
extern "C" int pd_conv3x3_int8_xshift(const void* x, const void* w, const void* s_a,
                                      const void* s_w, const void* bias, void* out,
                                      int batch, int h, int wd, int cin, int cout,
                                      int out_bf16, int vec, void* stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 ||
      (cout + BN - 1) / BN > 65535 || static_cast<int64_t>(9) * cin > (1 << 30) ||
      static_cast<int64_t>(batch) * h > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  XsParams xp;
  Params& p = xp.p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(w);
  p.s_a = static_cast<const float*>(s_a);
  p.s_w = static_cast<const float*>(s_w);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.h = h; p.wd = wd; p.cin = cin; p.cout = cout;
  p.k_total = 9 * cin;
  p.m_total = static_cast<int64_t>(batch) * h * wd;
  p.out_bf16 = out_bf16;
  xp.wide = wd > XS_WIDE;
  xp.xtiles = (wd + BM - 1) / BM;
  xp.slots = xs_slots(wd);
  const int64_t m_blocks =
      xp.wide ? static_cast<int64_t>(batch) * h * xp.xtiles : (p.m_total + BM - 1) / BM;
  if (m_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = xs_smem(xp.slots);
  cudaError_t err = vec ? cudaFuncSetAttribute(conv3x3_int8_xshift_kernel<true>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem))
                        : cudaFuncSetAttribute(conv3x3_int8_xshift_kernel<false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(m_blocks), (cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    conv3x3_int8_xshift_kernel<true><<<grid, NTHREADS, smem, s>>>(xp);
  } else {
    conv3x3_int8_xshift_kernel<false><<<grid, NTHREADS, smem, s>>>(xp);
  }
  return static_cast<int>(cudaGetLastError());
}
