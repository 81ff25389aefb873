// Shared helpers for the port's hand-written Hopper kernels.
//
// Element types travel across the plain C interface as an int code
// (DTYPE_F32 / DTYPE_F16 / DTYPE_BF16, and for a quantized KV cache's
// values DTYPE_I8 / DTYPE_E4M3, matching ops/_build.py); every kernel
// loads its inputs through Cvt<T> into float registers and accumulates
// in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dl4j {

enum DType {
  DTYPE_F32 = 0,
  DTYPE_F16 = 1,
  DTYPE_BF16 = 2,
  DTYPE_I8 = 3,
  DTYPE_E4M3 = 4
};

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};

template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float to(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from(float x) {
    return __float2half_rn(x);
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
};

// The quantized cache's int8 values: read only, each exactly a float.
template <>
struct Cvt<int8_t> {
  static __device__ __forceinline__ float to(int8_t x) {
    return static_cast<float>(x);
  }
};

// x rounded to T and back: the probability cast of the reference kernels
// (p.astype(v.dtype) before the PV product).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Cvt<T>::to(Cvt<T>::from(x));
}

// 16 bytes of T unpacked to float.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  constexpr int N = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = Cvt<T>::to(e[i]);
}

// 16 e4m3 values unpacked to float, exactly: two at a time by the sm_89+
// cvt to a half pair (every e4m3 value is a half, every half a float).
// Byte k of the vector is element k; a pair's low byte is its low half.
template <>
__device__ __forceinline__ void load16<__nv_fp8_e4m3>(
    const __nv_fp8_e4m3* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const unsigned short pair = (unsigned short)(w[i] >> (16 * j));
      unsigned int h2;
      asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"(pair));
      dst[4 * i + 2 * j] =
          __half2float(__ushort_as_half((unsigned short)(h2 & 0xffffu)));
      dst[4 * i + 2 * j + 1] =
          __half2float(__ushort_as_half((unsigned short)(h2 >> 16)));
    }
  }
}

// Finite "minus infinity" of the reference (NEG_INF = -1e30): a fully
// masked row averages uniformly, exactly as in JAX.
constexpr float NEG_INF = -1e30f;

// Rows [row0, row0 + ROWS) of a contiguous [nrows, DH] matrix of T, as
// float, into a shared-memory tile with row stride STRIDE; rows at or
// past nrows read as zero (the ragged tail). All NT threads take part.
template <typename T, int DH, int STRIDE, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int row0, int nrows) {
  for (int idx = threadIdx.x; idx < ROWS * DH; idx += NT) {
    const int r = idx / DH;
    const int c = idx - r * DH;
    const int g = row0 + r;
    dst[r * STRIDE + c] =
        g < nrows ? Cvt<T>::to(src[(size_t)g * DH + c]) : 0.f;
  }
}

}  // namespace dl4j
