// Helpers shared by the int8 epilogue kernels (row_quant.cu, gn_quant.cu) and
// K9's prologue (int8_attention.cu): 16-byte vectors of bf16 or fp32 values,
// and the IEEE quotient, rint and byte packing of the int8 codes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // 8 floats rounded to bf16 (to nearest, ties to even, as a cast)
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

}  // namespace

namespace rq {

// __fdiv_rn(y, s) from r = __frcp_rn(s): y * r is within 1.5 ulp of y / s;
// the residual s * q0 - y is one FMA, and one more FMA, q0 - residual * r,
// corrects q0 to the quotient rounded to nearest. Bit-equal for y = +-0 (the
// residual's sign keeps -0) and wherever the residual does not underflow,
// |y| > ~2^-100 (s >= 1e-8); below that both round to the code 0.
__device__ __forceinline__ float quotient(float y, float s, float r) {
  const float q0 = __fmul_rn(y, r);
  return fmaf(fmaf(s, q0, -y), -r, q0);
}

// The int8 code of q (|q| < 2^22) as the low byte of the bits of
// q + 1.5 * 2^23: the add rounds q to an integer, ties to even (as rintf),
// and the low byte holds it in two's complement.
__device__ __forceinline__ uint32_t code_bits(float q) {
  return __float_as_uint(__fadd_rn(q, 12582912.0f));
}

// The low bytes of a, b, c, d as bytes 0..3 of one word.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

}  // namespace rq
