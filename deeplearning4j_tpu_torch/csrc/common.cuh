// Shared helpers for the port's hand-written Hopper kernels.
//
// Element types travel across the plain C interface as an int code
// (DTYPE_F32 / DTYPE_F16 / DTYPE_BF16, matching ops/_build.py); every
// kernel loads its inputs through Cvt<T> into float registers and
// accumulates in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace dl4j {

enum DType { DTYPE_F32 = 0, DTYPE_F16 = 1, DTYPE_BF16 = 2 };

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

// Finite "minus infinity" of the reference (NEG_INF = -1e30): a fully
// masked row averages uniformly, exactly as in JAX.
constexpr float NEG_INF = -1e30f;

}  // namespace dl4j
