// float <-> storage-type conversions shared by the kernels (float32,
// bfloat16 and int8 operands; all arithmetic is float).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round a float to storage type T and back (e.g. p.astype(v.dtype))
template <typename T>
__device__ __forceinline__ float round_as(float x) { return to_f(from_f<T>(x)); }

}  // namespace
