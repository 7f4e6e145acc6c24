// int8 SAME 3x3 stride-1 convolution for Hopper (sm_90a), NHWC.
//
// Replaces the TPU kernel prompt_diffusion_tpu/ops/int8_conv.py::
// conv3x3_int8 in both of its variants: `_conv_kernel` ("im2col", the
// JAX default) and `_conv_kernel_xshift` ("xshift"). They serve the 3x3
// convs of the int8 W8A8 serving mode (ResBlock in/out convs, Upsample, the
// latent input conv, the int8 VAE) and compute one function:
//
//   out[b, y, x, n] = bf16|f32( fma(f32(acc), s_a[b] * s_w[n], bias[n]) )
//   acc             = sum over (dy, dx, ci) of
//                     xq[b, y+dy-1, x+dx-1, ci] * wq[n, dy, dx, ci]   (int32)
//
// The int32 sum is exact in any order. The epilogue rounds s_a*s_w first
// (__fmul_rn), then acc*scale + bias once, as one fused multiply-add
// (__fmaf_rn), as the JAX package's kernel and its XLA path compute it on
// the CPU, then to bf16 to nearest even. The explicit intrinsics fix where
// nvcc rounds, and both routes equal the plain PyTorch versions (int8
// im2col or nine shifted per-tap products, torch._int_mm, the same
// epilogue) and each other bit for bit.
//
// What bounds them. At the SD1.5 shapes each conv is an int8 matrix
// product, M = B*H*W pixels by N = Cout by K = 9*Cin (2880..23040), of
// 2*M*N*K operations against M*Cin + 9*Cin*N + M*N*2 bytes: several
// hundred operations a byte, above the ~590 int8 operations per byte of
// device memory at which the tensor cores, not the memory, are the limit.
// So the design's work is to keep the tensor cores fed:
//   * `wgmma` m64nNk32 s8 (N = 128, or 64 for the last 64 columns of Cout =
//     320), int32 accumulators in registers; a block is two warpgroups and
//     an output tile of 128 x 128 (pixels x Cout) or, for xshift where the
//     tiles still fill every SM, 256 x 128 (MT = 2): each warpgroup holds MT
//     slabs of 64 rows (64 accumulators a thread per slab);
//   * a three-stage ring in dynamic shared memory, filled by 16-byte
//     `cp.async.cg` copies whose src-size 0 form zero-fills the SAME
//     padding and the M, N and K tails: one barrier per stage, and the
//     copies of stage t+2 are in flight while stage t is multiplied. Each
//     stage's products are issued together and waited for before the next
//     barrier (no `wgmma` stays in flight across it); two im2col blocks per
//     SM cover that wait. cp.async and not TMA: the im2col rows are
//     gathered per pixel and tap with per-row masks, xshift's halo rows
//     start at any pixel, and the Cin = 4 input conv has 4-byte rows, which
//     TMA's 16-byte strides refuse;
//   * each output row's (b, y, x), and which of its nine taps lie inside
//     its image, worked out once per tile; the K position of a thread's
//     copies advances by additions (no division in the K loop);
//   * split-K (grid z) where the tiles fill at most half of the blocks the
//     card holds at once (the 8x8 latents, and 16x16 at CFG batch 4 under
//     im2col): each split sums whole ring stages into int32 partials in a
//     workspace the wrapper allocates, and `splitk_epilogue_kernel` adds
//     them in a fixed order and applies the epilogue (int32 sums are exact
//     in any order, so the bits do not change). The plan (tile height,
//     splits, stages per split) is ops/int8_conv.py::conv_plan's, passed
//     down by the wrapper;
//   * the epilogue from registers: s_a of each tile row and s_w, bias of
//     each tile column staged once per tile, the dequant applied to the
//     accumulator fragments, the tile staged through shared memory (the
//     dead ring) and stored 16 bytes a thread, coalesced along Cout.
// The routes differ in how the A operand reaches the tensor cores:
//   * "im2col" (`conv3x3_int8_kernel`): a ring stage is a 128-byte slice of
//     the implicit im2col rows (k = tap * Cin + ci) and of the weight rows,
//     each gathered straight from device memory per 16-byte chunk (a chunk
//     never crosses a tap when Cin % 16 == 0, so slices need not stay
//     within a tap: Cin = 320 and 960 are not multiples of 128). Rows of
//     128 bytes in the 128-byte swizzle (chunk c of row r at c ^ (r % 8)),
//     so both operands are read by `wgmma` from shared memory through
//     descriptors. Every input pixel is read up to nine times, once per
//     tap, mostly from L2, which is what the route pays. 98 KB a block, two
//     blocks per SM;
//   * "xshift" (`conv3x3_int8_xshift_kernel`), the TPU variant's idea: a
//     ring stage is a 32-channel slice of the raw input rows the tile's
//     pixels touch, with their one-pixel halo ((rows + 2) x (W + 2) pixels,
//     or 3 x 130 when a row is wider than 128 pixels, the int8 VAE's 512²),
//     beside the same slice of all nine taps' weights (36 KB, 32-byte rows
//     in the 32-byte swizzle, B of `wgmma` by descriptor); the nine taps run
//     as shifted products over it (K = 288 bytes a stage). A shifted view
//     moves a row by one 48-byte pixel slot, which no swizzle can follow, so
//     A reaches `wgmma` from registers (its RS form: each warp's 16 rows in
//     the m16n8k32 A fragment layout), loaded by `ldmatrix` with one address
//     per row: each lane points at its pixel's slot for the tap, or at a
//     zero slot where the tap falls outside the pixel's own image (a tile
//     spans several image rows and, at the 8x8 latents, several images).
//     Slots of 48 bytes put the 8 rows of an `ldmatrix` in distinct banks.
//     Activation traffic is one read of each staged pixel per tile instead
//     of nine; the `ldmatrix` of A and the larger ring (140-205 KB, one
//     block per SM) are what it pays.
// Cin % 16 != 0 (the 4-channel latent input conv, 0.02% of the operations)
// takes a byte gather into the same ring, synchronous, K = 36 in one stage
// (im2col) or 32 channels (xshift), never split.
// Registers (ptxas, `tools/conv_tune.py --part ptxas`): no instantiation
// spills. What bounds them now, on the card (PERF.md): im2col runs at about
// a third of the int8 peak, where by a count of its bytes its re-reads of A
// (once per tap) and B (once per pixel tile) come near the L2's rate;
// xshift's one block per SM waits at each stage for its products and its
// `ldmatrix` of A, with no second block to fill the wait.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A tile is MT x 128 output pixels (MT = 1, or 2 for xshift where the plan
// says so) by BN output channels; warpgroup wg (of two) multiplies rows
// 64 MT wg.. as MT slabs of 64 rows.
constexpr int BN = 128;           // output channels per tile
constexpr int NTHREADS = 256;     // two warpgroups
constexpr int STAGES = 3;         // ring depth
constexpr int IM_BK = 128;        // im2col: K bytes per stage
constexpr int XS_CS = 32;         // xshift: channels per stage, all nine taps
constexpr int XS_SLOT = 48;       // bytes per staged pixel (32 + 16 of pad)
constexpr int XS_WIDE = 128;      // rows wider than this are tiled in x (MT = 1)
constexpr int XS_WSTAGE = 9 * BN * XS_CS;
constexpr int EPI_PITCH_BF16 = BN * 2 + 16;  // bytes per staged output row
constexpr int EPI_PITCH_F32 = BN * 4 + 16;
constexpr int ZERO_BYTES = 128;               // xshift's zero slot
constexpr int MAX_SMEM = 232448;

struct Params {
  const int8_t* x;     // (B, H, W, Cin)
  const int8_t* wt;    // (Cout, 3, 3, Cin)
  const float* s_a;    // (B,)
  const float* s_w;    // (Cout,)
  const float* bias;   // (Cout,) or null
  void* out;           // (B, H, W, Cout), bf16 or f32
  int32_t* ws;         // split-K partials (splits, M, Cout), or null
  int h, wd, cin, cout, k_total;
  int64_t m_total;
  int out_bf16;
  int nslices;         // ring stages of the whole K
  int per_split;       // ring stages per split (grid z)
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int align1024(int n) { return (n + 1023) / 1024 * 1024; }

// Shared memory, in bytes, of a tile of MT x 128 pixels: the epilogue's
// fp32 staging, s_a per row with s_w and bias per column, im2col's stage
// and its ring (or the staging after it) and the whole, 1024 bytes of
// slack for aligning the start included.
template <int MT>
struct Tile {
  static constexpr int BM = 128 * MT;
  static constexpr int EPI = BM * EPI_PITCH_F32;
  static constexpr int VEC = (BM + 2 * BN) * 4;
  static constexpr int IM_STAGE = (BM + BN) * IM_BK;
  static constexpr int IM_MAIN = cmax(STAGES * IM_STAGE, EPI);
  static constexpr int IM_SMEM = IM_MAIN + VEC + 1024;
};

// xshift: bytes of staged halo per stage, the ring (or the epilogue's
// staging after it), and the whole dynamic shared memory
__host__ __device__ inline int xs_stage(int halo) { return halo + XS_WSTAGE; }
template <int MT>
__host__ __device__ inline int xs_main(int halo) {
  return cmax(STAGES * xs_stage(halo), Tile<MT>::EPI);
}
template <int MT>
__host__ inline int xs_smem(int halo) {
  return xs_main<MT>(halo) + ZERO_BYTES + Tile<MT>::VEC + 1024;
}

// staged pixel slots a tile of bm pixels may need
__host__ inline int xs_slots(int wd, int bm) {
  if (wd > XS_WIDE) return 3 * (XS_WIDE + 2);
  return ((wd + bm - 2) / wd + 3) * (wd + 2);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zeros when !ok (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr))
               : "memory");
}

// ---- wgmma: one warpgroup's 64 x N x 32 int8 product into int32 registers

// A shared-memory matrix descriptor of a K-major tile: rows of `row_bytes`
// (128 with the 128-byte swizzle, 32 with the 32-byte one), groups of 8
// rows `8 * row_bytes` apart; the leading byte offset is unused (1).
__device__ __forceinline__ uint64_t smem_desc(const void* p, int row_bytes) {
  const int layout = row_bytes == 128 ? 1 : 3;  // SWIZZLE_128B : SWIZZLE_32B
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * row_bytes >> 4) << 32) | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the copies' shared-memory writes made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving or reusing registers an in-flight wgmma owns
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define PD_D4(i) "+r"(d[i]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3])
#define PD_D16(i) PD_D4(i), PD_D4((i) + 4), PD_D4((i) + 8), PD_D4((i) + 12)
#define PD_R32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define PD_R64                                                                          \
  PD_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
         "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x N, this thread's N/2 values) += A (64 x 32) * B (N x 32)^T, A and
// B from shared memory (descriptors); N = 128 or 64 (d[0..31]). The
// predicate (scale-d, 1: accumulate) is set from a register, as PTX asks.
template <int N>
__device__ __forceinline__ void wgmma_ss(int (&d)[64], uint64_t da, uint64_t db) {
  if (N == 128) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PD_R64 "}, %64, %65, p;\n}\n"
                 : PD_D16(0), PD_D16(16), PD_D16(32), PD_D16(48)
                 : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " PD_R32 "}, %32, %33, p;\n}\n"
                 : PD_D16(0), PD_D16(16)
                 : "l"(da), "l"(db), "r"(1));
  }
}

// the same with A from registers: each warp's 16 rows in the m16n8k32 A
// fragment layout (`ldmatrix_x4`)
template <int N>
__device__ __forceinline__ void wgmma_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  if (N == 128) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PD_R64
                 "}, {%64, %65, %66, %67}, %68, p;\n}\n"
                 : PD_D16(0), PD_D16(16), PD_D16(32), PD_D16(48)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " PD_R32
                 "}, {%32, %33, %34, %35}, %36, p;\n}\n"
                 : PD_D16(0), PD_D16(16)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

__device__ __forceinline__ float dequant(int acc, float sa, float sw, float bias, bool has_bias) {
  const float scale = __fmul_rn(sa, sw);
  const float a = __int2float_rn(acc);
  return has_bias ? __fmaf_rn(a, scale, bias) : __fmul_rn(a, scale);
}

// s_a of each of the bm tile rows (output pixels mstart.. of which `rows`
// exist), then s_w and bias of each tile column, into shared memory.
__device__ __forceinline__ void load_tile_vectors(const Params& p, float* t_sa, int bm,
                                                  int64_t mstart, int rows, int n0) {
  const int64_t hw = static_cast<int64_t>(p.h) * p.wd;
  for (int i = threadIdx.x; i < bm + BN; i += NTHREADS) {
    if (i < bm) {
      t_sa[i] = i < rows ? p.s_a[(mstart + i) / hw] : 0.f;
    } else {
      const int n = n0 + i - bm;
      t_sa[i] = n < p.cout ? p.s_w[n] : 0.f;
      t_sa[i + BN] = n < p.cout && p.bias != nullptr ? p.bias[n] : 0.f;
    }
  }
}

// The tile's accumulators out. Warpgroup wg holds rows 64 (MT wg + mt)..
// in d[mt], warp w of it rows 16 w.. of each slab: this thread's
// d[mt][4 j + e] is row g + 8 (e / 2), column 8 j + 2 q + e % 2 (g = lane
// / 4, q = lane % 4). Without a split, dequantized, staged through shared
// memory (`stage`, the dead ring) and stored 16 bytes a thread; with one,
// the int32 partials of split `z` into the workspace. Rows mstart..
// mstart + rows - 1 of the output, columns n0.. of Cout.
template <int MT>
__device__ void store_tile(const Params& p, const int (&d)[MT][64], unsigned char* stage,
                           const float* t_sa, int64_t mstart, int rows, int n0, int z) {
  constexpr int BM = Tile<MT>::BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = (warp >> 2) * 64 * MT + (warp & 3) * 16 + g;
  if (p.ws != nullptr) {
    int32_t* ws = p.ws + static_cast<int64_t>(z) * p.m_total * p.cout;
    const bool pairs = (p.cout & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + 64 * mt + 8 * hh;
          const int n = n0 + j * 8 + 2 * q;
          if (r >= rows || n >= p.cout) continue;
          int32_t* dst = ws + (mstart + r) * p.cout + n;
          const int v0 = d[mt][4 * j + 2 * hh], v1 = d[mt][4 * j + 2 * hh + 1];
          if (pairs) {
            *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
          } else {
            dst[0] = v0;
            if (n + 1 < p.cout) dst[1] = v1;
          }
        }
      }
    }
    return;
  }
  const float* t_sw = t_sa + BM;
  const float* t_bias = t_sa + BM + BN;
  const bool has_bias = p.bias != nullptr;
  const int pitch = p.out_bf16 ? EPI_PITCH_BF16 : EPI_PITCH_F32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 64 * mt + 8 * hh;
      const float sa = t_sa[r];
      unsigned char* dst = stage + r * pitch;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = j * 8 + 2 * q;
        const float v0 = dequant(d[mt][4 * j + 2 * hh], sa, t_sw[c], t_bias[c], has_bias);
        const float v1 =
            dequant(d[mt][4 * j + 2 * hh + 1], sa, t_sw[c + 1], t_bias[c + 1], has_bias);
        if (p.out_bf16) {
          __nv_bfloat162 pair;
          pair.x = __float2bfloat16_rn(v0);
          pair.y = __float2bfloat16_rn(v1);
          *reinterpret_cast<__nv_bfloat162*>(dst + c * 2) = pair;
        } else {
          *reinterpret_cast<float2*>(dst + c * 4) = make_float2(v0, v1);
        }
      }
    }
  }
  __syncthreads();
  const int esize = p.out_bf16 ? 2 : 4;
  const int epc = 16 / esize;  // elements per 16-byte chunk
  const int cpr = BN / epc;    // chunks per tile row
  const bool vec = p.cout % epc == 0;
  unsigned char* out = static_cast<unsigned char*>(p.out);
  for (int e = tid; e < BM * cpr; e += NTHREADS) {
    const int r = e / cpr, cc = e - r * cpr;
    const int n = n0 + cc * epc;
    if (r >= rows || n >= p.cout) continue;
    const unsigned char* src = stage + r * pitch + cc * 16;
    unsigned char* dst = out + ((mstart + r) * p.cout + n) * esize;
    if (vec) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      const int cnt = p.cout - n < epc ? p.cout - n : epc;
      for (int b = 0; b < cnt * esize; ++b) dst[b] = src[b];
    }
  }
}

// The 1024-byte aligned start of dynamic shared memory (the swizzled tiles'
// atoms must start on 1024-byte boundaries; the launch adds the slack).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* smem) {
  return smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
}

// ---- the im2col route -----------------------------------------------------

// Tiles of 128 pixels (MT = 1) only: 256-pixel tiles hold one block per
// SM instead of two, and were slower when tried on the card.
template <bool VEC>
__global__ void __launch_bounds__(NTHREADS, 2) conv3x3_int8_kernel(Params p) {
  constexpr int MT = 1;
  using T = Tile<MT>;
  constexpr int BM = T::BM, AR = BM / 32;  // tile rows; A rows a thread copies
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = aligned_smem(smem_raw);  // STAGES x [A: BM x IM_BK][B: BN x IM_BK]
  float* t_sa = reinterpret_cast<float*>(ring + T::IM_MAIN);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int rows = static_cast<int>(p.m_total - m0 < BM ? p.m_total - m0 : BM);
  const int kt0 = blockIdx.z * p.per_split;
  const int nkt = p.nslices - kt0 < p.per_split ? p.nslices - kt0 : p.per_split;
  load_tile_vectors(p, t_sa, BM, m0, rows, n0);

  // This thread's copies: 16-byte chunk c of tile rows r0 + 32 i, A and B.
  // Each A row's pixel and its taps inside the image, once per tile.
  const int c = tid & 7, r0 = tid >> 3;
  const int swz = (c ^ (r0 & 7)) << 4;
  const int hw = p.h * p.wd;
  const int8_t* a_px[AR];
  unsigned a_taps[AR];
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int64_t m = m0 + r0 + 32 * i;
    a_px[i] = p.x;
    a_taps[i] = 0;
    if (m < p.m_total) {
      const int b = static_cast<int>(m / hw);
      const int rem = static_cast<int>(m - static_cast<int64_t>(b) * hw);
      const int y = rem / p.wd, x = rem - y * p.wd;
      a_px[i] = p.x + m * p.cin;
      unsigned mask = 0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int iy = y + dy - 1, ix = x + dx - 1;
          if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.wd) mask |= 1u << (dy * 3 + dx);
        }
      a_taps[i] = mask;
    }
  }
  const int8_t* b_row = p.wt + static_cast<int64_t>(n0 + r0) * p.k_total;
  // the chunk's K position k = tap * Cin + ci, advanced by additions
  int k = kt0 * IM_BK + c * 16;
  int tap = k / p.cin, ci = k - tap * p.cin;

  auto load_stage = [&](int slot) {
    int8_t* sa = reinterpret_cast<int8_t*>(ring) + slot * T::IM_STAGE;
    int8_t* sb = sa + BM * IM_BK;
    if (VEC) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const int64_t off = (static_cast<int64_t>(dy - 1) * p.wd + (dx - 1)) * p.cin + ci;
#pragma unroll
      for (int i = 0; i < AR; ++i) {
        const bool ok = tap < 9 && ((a_taps[i] >> tap) & 1u);
        cp_async16(sa + (r0 + 32 * i) * IM_BK + swz, ok ? a_px[i] + off : p.x, ok);
      }
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const bool ok = k < p.k_total && n0 + r0 + 32 * i < p.cout;
        cp_async16(sb + (r0 + 32 * i) * IM_BK + swz,
                   ok ? b_row + static_cast<int64_t>(32 * i) * p.k_total + k : p.wt, ok);
      }
    } else {
      for (int i = 0; i < AR; ++i) {
        int8_t* da = sa + (r0 + 32 * i) * IM_BK + swz;
        for (int j = 0; j < 16; ++j) {
          const int kj = k + j;
          int8_t va = 0;
          if (kj < p.k_total) {
            const int t = kj / p.cin, cj = kj - t * p.cin;
            if ((a_taps[i] >> t) & 1u) {
              const int dy = t / 3, dx = t - dy * 3;
              va = a_px[i][(static_cast<int64_t>(dy - 1) * p.wd + (dx - 1)) * p.cin + cj];
            }
          }
          da[j] = va;
        }
      }
      for (int i = 0; i < BN / 32; ++i) {
        int8_t* db = sb + (r0 + 32 * i) * IM_BK + swz;
        const bool n_ok = n0 + r0 + 32 * i < p.cout;
        for (int j = 0; j < 16; ++j) {
          const int kj = k + j;
          db[j] = n_ok && kj < p.k_total ? b_row[static_cast<int64_t>(32 * i) * p.k_total + kj]
                                         : static_cast<int8_t>(0);
        }
      }
    }
    k += IM_BK;
    ci += IM_BK;
    while (ci >= p.cin) {
      ci -= p.cin;
      ++tap;
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load_stage(s);
    cp_async_commit();
  }

  // Warpgroup wg multiplies tile rows 64 MT wg.. by all 128 columns, or by
  // the first 64 where no more of Cout is left (the last tile of 320).
  int d[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) d[mt][i] = 0;
  const int wg = warp >> 2;
  const bool narrow = p.cout - n0 <= 64;

  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // stage t has landed; stage t - 1's products are done
    if (t + STAGES - 1 < nkt) load_stage((t + STAGES - 1) % STAGES);
    cp_async_commit();
    const int8_t* sa = reinterpret_cast<const int8_t*>(ring) + (t % STAGES) * T::IM_STAGE;
    const int8_t* sb = sa + BM * IM_BK;
    sa += wg * 64 * MT * IM_BK;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(d[mt]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < IM_BK / 32; ++kk) {
      const uint64_t db = smem_desc(sb + kk * 32, IM_BK);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint64_t da = smem_desc(sa + mt * 64 * IM_BK + kk * 32, IM_BK);
        if (narrow) {
          wgmma_ss<64>(d[mt], da, db);
        } else {
          wgmma_ss<128>(d[mt], da, db);
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(d[mt]);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead; the epilogue stages through it
  store_tile<MT>(p, d, ring, t_sa, m0, rows, n0, blockIdx.z);
}

// ---- the xshift route -----------------------------------------------------

template <bool VEC>
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* src, bool ok) {
  if (VEC) {
    cp_async16(dst, src, ok);
  } else {
    for (int j = 0; j < 16; ++j) dst[j] = ok ? src[j] : static_cast<int8_t>(0);
  }
}

// halo: bytes of staged pixels per stage; wide: W > XS_WIDE, a tile is 128
// pixels of one row (MT = 1), xtiles tiles per row
template <bool VEC, int MT>
__global__ void __launch_bounds__(NTHREADS, 1)
    conv3x3_int8_xshift_kernel(Params p, int halo, int wide, int xtiles) {
  constexpr int BM = Tile<MT>::BM;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // STAGES x [halo: slots x XS_SLOT][weights: 9 taps x BN x XS_CS]
  unsigned char* ring = aligned_smem(smem_raw);
  const int stage_bytes = xs_stage(halo);
  int8_t* zero = reinterpret_cast<int8_t*>(ring + xs_main<MT>(halo));
  float* t_sa = reinterpret_cast<float*>(ring + xs_main<MT>(halo) + ZERO_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * BN;
  const int rows_total = static_cast<int>(p.m_total / p.wd);  // B*H image rows
  const int kt0 = blockIdx.z * p.per_split;
  const int nkt = p.nslices - kt0 < p.per_split ? p.nslices - kt0 : p.per_split;

  // the tile: 128 positions t, output pixels mstart + t while t < rows
  int64_t mstart;
  int rows, g_first, g_last, x_lo, x_hi;
  if (!wide) {
    mstart = static_cast<int64_t>(blockIdx.x) * BM;
    rows = static_cast<int>(p.m_total - mstart < BM ? p.m_total - mstart : BM);
    g_first = static_cast<int>(mstart / p.wd);
    g_last = static_cast<int>((mstart + rows - 1) / p.wd);
    x_lo = 0;
    x_hi = p.wd - 1;
  } else {
    g_first = g_last = blockIdx.x / xtiles;
    x_lo = (blockIdx.x % xtiles) * BM;
    x_hi = (x_lo + BM < p.wd ? x_lo + BM : p.wd) - 1;
    mstart = static_cast<int64_t>(g_first) * p.wd + x_lo;
    rows = x_hi - x_lo + 1;
  }
  const int gs = g_first - 1, xs = x_lo - 1;  // staged origin (with the halo)
  const int nr = g_last - g_first + 3, nc = x_hi - x_lo + 3;
  load_tile_vectors(p, t_sa, BM, mstart, rows, n0);
  if (tid < ZERO_BYTES / 16) {
    *reinterpret_cast<int4*>(zero + tid * 16) = make_int4(0, 0, 0, 0);
  }

  // This lane's ldmatrix rows: warp w of warpgroup wg loads the A
  // fragment of tile rows 64 (MT wg + mt) + 16 w.. of each slab mt (rows
  // (lane & 7) + 8 * bit 3 of the lane, bytes 16 * (lane >> 4) of the 32);
  // each row's pixel's centre slot and which of the nine taps stay in its
  // image.
  const int akoff = (lane >> 4) * 16;
  int centre[MT];
  unsigned taps[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int t_row = ((warp >> 2) * MT + mt) * 64 + (warp & 3) * 16 + (lane & 7) +
                      ((lane >> 3) & 1) * 8;
    const int64_t m = mstart + t_row;
    const int g = static_cast<int>(m / p.wd);
    const int x = static_cast<int>(m - static_cast<int64_t>(g) * p.wd);
    const int y = g % p.h;
    centre[mt] = (g - gs) * nc + (x - xs);
    taps[mt] = 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int iy = y + dy - 1, ix = x + dx - 1;
        if (t_row < rows && iy >= 0 && iy < p.h && ix >= 0 && ix < p.wd) {
          taps[mt] |= 1u << (dy * 3 + dx);
        }
      }
  }

  // This thread's weight copies: row n of the tile, half `whalf` of the
  // 32-channel slice, for each of the nine taps; a 32-byte weight row's two
  // chunks are swapped when (n / 4) is odd (the 32-byte swizzle).
  const int wrow = tid >> 1, whalf = tid & 1;
  const bool w_ok = n0 + wrow < p.cout;
  const int8_t* w_src = p.wt + static_cast<int64_t>(n0 + wrow) * p.k_total + whalf * 16;
  const int w_dst = wrow * XS_CS + ((whalf ^ ((wrow >> 2) & 1)) << 4);

  auto load_stage = [&](int slot, int s) {
    int8_t* hs = reinterpret_cast<int8_t*>(ring) + slot * stage_bytes;
    int8_t* wsm = hs + halo;
    const int c0 = s * XS_CS;
    for (int i = tid; i < nr * nc * 2; i += NTHREADS) {
      const int sl = i >> 1, half = i & 1;
      const int rr = sl / nc, cc = sl - rr * nc;
      const int gg = gs + rr, xx = xs + cc;
      const int ch = c0 + half * 16;
      const bool ok = gg >= 0 && gg < rows_total && xx >= 0 && xx < p.wd && ch < p.cin;
      const int8_t* src = ok ? p.x + (static_cast<int64_t>(gg) * p.wd + xx) * p.cin + ch : p.x;
      if (VEC) {
        copy16<true>(hs + sl * XS_SLOT + half * 16, src, ok);
      } else {
        int8_t* dst = hs + sl * XS_SLOT + half * 16;
        for (int j = 0; j < 16; ++j) dst[j] = ok && ch + j < p.cin ? src[j] : static_cast<int8_t>(0);
      }
    }
    const int ch = c0 + whalf * 16;
#pragma unroll
    for (int tp = 0; tp < 9; ++tp) {
      const bool ok = w_ok && ch < p.cin;
      const int8_t* src = ok ? w_src + tp * p.cin + c0 : p.wt;
      if (VEC) {
        copy16<true>(wsm + tp * BN * XS_CS + w_dst, src, ok);
      } else {
        int8_t* dst = wsm + tp * BN * XS_CS + w_dst;
        for (int j = 0; j < 16; ++j) dst[j] = ok && ch + j < p.cin ? src[j] : static_cast<int8_t>(0);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load_stage(s, kt0 + s);
    cp_async_commit();
  }

  int d[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) d[mt][i] = 0;
  const bool narrow = p.cout - n0 <= 64;

  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // stage t has landed; stage t - 1's products are done
    if (t + STAGES - 1 < nkt) load_stage((t + STAGES - 1) % STAGES, kt0 + t + STAGES - 1);
    cp_async_commit();
    const int8_t* hs = reinterpret_cast<const int8_t*>(ring) + (t % STAGES) * stage_bytes;
    const int8_t* wsm = hs + halo;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // the nine taps' A fragments of slab mt: the pixel's slot shifted by
      // the tap, or the zero slot; all in registers before the products
      // read them, and kept until those are done
      uint32_t a[9][4];
#pragma unroll
      for (int tp = 0; tp < 9; ++tp) {
        const int shift = (tp / 3 - 1) * nc + (tp % 3 - 1);
        ldmatrix_x4(a[tp], (taps[mt] >> tp) & 1u ? hs + (centre[mt] + shift) * XS_SLOT + akoff
                                                 : zero + akoff);
      }
      fence_regs(d[mt]);
      wgmma_fence();
#pragma unroll
      for (int tp = 0; tp < 9; ++tp) {
        const uint64_t db = smem_desc(wsm + tp * BN * XS_CS, XS_CS);
        if (narrow) {
          wgmma_rs<64>(d[mt], a[tp], db);
        } else {
          wgmma_rs<128>(d[mt], a[tp], db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(d[mt]);
#pragma unroll
      for (int tp = 0; tp < 9; ++tp) fence_regs(a[tp]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead; the epilogue stages through it
  store_tile<MT>(p, d, ring, t_sa, mstart, rows, n0, blockIdx.z);
}

// ---- split-K: the partials summed, then the epilogue ----------------------

__global__ void __launch_bounds__(256) splitk_epilogue_kernel(Params p, int splits) {
  const int64_t total = p.m_total * p.cout;
  const int64_t hw = static_cast<int64_t>(p.h) * p.wd;
  const bool has_bias = p.bias != nullptr;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x * 4;
  for (int64_t e = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4; e < total;
       e += step) {
    if ((p.cout & 3) == 0) {  // four columns of one row, 16-byte loads
      int acc[4] = {0, 0, 0, 0};
      for (int z = 0; z < splits; ++z) {
        const int4 v = *reinterpret_cast<const int4*>(p.ws + z * total + e);
        acc[0] += v.x;
        acc[1] += v.y;
        acc[2] += v.z;
        acc[3] += v.w;
      }
      const int64_t m = e / p.cout;
      const int n = static_cast<int>(e - m * p.cout);
      const float sa = p.s_a[m / hw];
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = dequant(acc[j], sa, p.s_w[n + j], has_bias ? p.bias[n + j] : 0.f, has_bias);
      }
      if (p.out_bf16) {
        __nv_bfloat162 lo, hi;
        lo.x = __float2bfloat16_rn(v[0]);
        lo.y = __float2bfloat16_rn(v[1]);
        hi.x = __float2bfloat16_rn(v[2]);
        hi.y = __float2bfloat16_rn(v[3]);
        uint2 pk;
        pk.x = *reinterpret_cast<const uint32_t*>(&lo);
        pk.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + e) = pk;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(p.out) + e) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      for (int64_t ee = e; ee < e + 4 && ee < total; ++ee) {
        int acc = 0;
        for (int z = 0; z < splits; ++z) acc += p.ws[z * total + ee];
        const int64_t m = ee / p.cout;
        const int n = static_cast<int>(ee - m * p.cout);
        const float v = dequant(acc, p.s_a[m / hw], p.s_w[n], has_bias ? p.bias[n] : 0.f, has_bias);
        if (p.out_bf16) {
          static_cast<__nv_bfloat16*>(p.out)[ee] = __float2bfloat16_rn(v);
        } else {
          static_cast<float*>(p.out)[ee] = v;
        }
      }
    }
  }
}

// Fills the parameters and checks the plan; returns cudaSuccess or
// cudaErrorInvalidValue.
cudaError_t make_params(Params& p, const void* x, const void* w, const void* s_a, const void* s_w,
                        const void* bias, void* out, void* ws, int batch, int h, int wd,
                        int cin, int cout, int out_bf16, int nslices, int splits,
                        int per_split) {
  if (batch <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 ||
      (cout + BN - 1) / BN > 65535 || static_cast<int64_t>(9) * cin > (1 << 30) ||
      static_cast<int64_t>(batch) * h > 0x7fffffff || splits < 1 || splits > 65535 ||
      per_split < 1 || static_cast<int64_t>(splits - 1) * per_split >= nslices ||
      static_cast<int64_t>(splits) * per_split < nslices || (splits > 1) != (ws != nullptr)) {
    return cudaErrorInvalidValue;
  }
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(w);
  p.s_a = static_cast<const float*>(s_a);
  p.s_w = static_cast<const float*>(s_w);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.ws = static_cast<int32_t*>(ws);
  p.h = h;
  p.wd = wd;
  p.cin = cin;
  p.cout = cout;
  p.k_total = 9 * cin;
  p.m_total = static_cast<int64_t>(batch) * h * wd;
  p.out_bf16 = out_bf16;
  p.nslices = nslices;
  p.per_split = per_split;
  return cudaSuccess;
}

// After the split kernel: the partials' sum and the epilogue.
cudaError_t launch_splitk_epilogue(const Params& p, int splits, cudaStream_t s) {
  const int64_t groups = (p.m_total * p.cout + 3) / 4;
  const int64_t blocks = (groups + 255) / 256;
  const unsigned grid = static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16);
  splitk_epilogue_kernel<<<grid, 256, 0, s>>>(p, splits);
  return cudaGetLastError();
}

template <class K>
cudaError_t allow_smem(K* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool VEC>
cudaError_t launch_im2col(const Params& p, int splits, cudaStream_t s) {
  const int64_t m_blocks = (p.m_total + Tile<1>::BM - 1) / Tile<1>::BM;
  if (m_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int smem = Tile<1>::IM_SMEM;
  cudaError_t err = allow_smem(conv3x3_int8_kernel<VEC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(m_blocks), (p.cout + BN - 1) / BN, splits);
  conv3x3_int8_kernel<VEC><<<grid, NTHREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool VEC, int MT>
cudaError_t launch_xshift(const Params& p, int batch, int splits, cudaStream_t s) {
  const int wide = p.wd > XS_WIDE;
  if (wide && MT != 1) return cudaErrorInvalidValue;
  const int xtiles = (p.wd + XS_WIDE - 1) / XS_WIDE;
  const int halo = align1024(xs_slots(p.wd, Tile<MT>::BM) * XS_SLOT);
  const int smem = xs_smem<MT>(halo);
  const int64_t m_blocks = wide ? static_cast<int64_t>(batch) * p.h * xtiles
                                : (p.m_total + Tile<MT>::BM - 1) / Tile<MT>::BM;
  if (m_blocks > 0x7fffffff || smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(conv3x3_int8_xshift_kernel<VEC, MT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(m_blocks), (p.cout + BN - 1) / BN, splits);
  conv3x3_int8_xshift_kernel<VEC, MT><<<grid, NTHREADS, smem, s>>>(p, halo, wide, xtiles);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// `vec` (Cin % 16 == 0 and 16-byte aligned x and w) selects the 16-byte
// copies. The plan (ops/int8_conv.py::conv_plan): tiles of `block_m`
// output pixels (128 here); `splits` over grid z of `per_split` ring
// stages each; with splits > 1, `ws` holds splits * M * Cout int32
// partials and a second kernel sums them.
extern "C" int pd_conv3x3_int8(const void* x, const void* w, const void* s_a, const void* s_w,
                               const void* bias, void* out, void* ws, int batch, int h, int wd,
                               int cin, int cout, int out_bf16, int vec, int block_m, int splits,
                               int per_split, void* stream) {
  Params p;
  const int nslices = static_cast<int>((static_cast<int64_t>(9) * cin + IM_BK - 1) / IM_BK);
  cudaError_t err = make_params(p, x, w, s_a, s_w, bias, out, ws, batch, h, wd, cin, cout,
                                out_bf16, nslices, splits, per_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_m != 128) return static_cast<int>(cudaErrorInvalidValue);
  err = vec ? launch_im2col<true>(p, splits, s) : launch_im2col<false>(p, splits, s);
  if (err == cudaSuccess && splits > 1) err = launch_splitk_epilogue(p, splits, s);
  return static_cast<int>(err);
}

// The xshift route; the same arguments and result, `per_split` counted in
// 32-channel slices; block_m 128, or 256 with vec where W <= 128.
extern "C" int pd_conv3x3_int8_xshift(const void* x, const void* w, const void* s_a,
                                      const void* s_w, const void* bias, void* out, void* ws,
                                      int batch, int h, int wd, int cin, int cout, int out_bf16,
                                      int vec, int block_m, int splits, int per_split,
                                      void* stream) {
  Params p;
  cudaError_t err = make_params(p, x, w, s_a, s_w, bias, out, ws, batch, h, wd, cin, cout,
                                out_bf16, (cin + XS_CS - 1) / XS_CS, splits, per_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_m == 128) {
    err = vec ? launch_xshift<true, 1>(p, batch, splits, s)
              : launch_xshift<false, 1>(p, batch, splits, s);
  } else if (block_m == 256 && vec) {
    err = launch_xshift<true, 2>(p, batch, splits, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess && splits > 1) err = launch_splitk_epilogue(p, splits, s);
  return static_cast<int>(err);
}
