// int8 SAME 3x3 stride-1 convolution for Hopper (sm_90a), NHWC.
//
// Replaces the TPU kernel prompt_diffusion_tpu/ops/int8_conv.py::
// conv3x3_int8 (_conv_kernel): the 3x3 convs of the int8 W8A8 serving mode
// (ResBlock in/out convs, Upsample, the latent input conv, the int8 VAE).
//
//   out[b, y, x, n] = bf16|f32( fma(f32(acc), s_a[b] * s_w[n], bias[n]) )
//   acc             = sum over (dy, dx, ci) of
//                     xq[b, y+dy-1, x+dx-1, ci] * wq[n, dy, dx, ci]   (int32)
//
// The int32 sum is exact. The epilogue rounds s_a*s_w first (__fmul_rn),
// then acc*scale + bias once, as one fused multiply-add (__fmaf_rn), as the
// JAX package's kernel and its XLA path compute it on the CPU, then to
// bf16 to nearest even. The explicit intrinsics fix where nvcc rounds, and
// the result equals the plain PyTorch version (int8 im2col +
// torch._int_mm + the same epilogue) bit for bit.
//
// What bounds it: at the SD1.5 512^2 shapes these convs are the largest
// matrix products of the step (K = 9*Cin = 2880..23040), so the kernel is
// an implicit GEMM on the tensor cores:
//   * M = B*H*W output pixels, N = Cout, K = (dy, dx, ci) in the order of
//     the (Cout, 3, 3, Cin) weight, which is the column-major B operand;
//   * one block of 8 warps owns a 128-pixel x 64-channel output tile and
//     walks K in slices of 32; each warp owns 32x32 of it as 2x2 WMMA
//     s8 16x16x16 fragments accumulating in int32;
//   * the A tile is gathered straight from the NHWC activation (no im2col
//     in device memory): with Cin % 16 == 0 a 16-byte load never crosses a
//     tap, so every load is one int4; the SAME padding and the tails in M,
//     N and K are zero-filled in the gather. Other Cin (the 4-channel
//     latent input conv) take a byte-wise gather;
//   * the accumulators go through shared memory to the fp32 epilogue,
//     whose stores are coalesced along Cout.
// Speed work (cp.async/TMA pipelining, mma.sync m16n8k32 or wgmma, larger
// tiles) is left to later changes.

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
