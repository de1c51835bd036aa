// Shared by the fused speller kernels (speller_decode.cu, speller_bwd.cu and
// their tensor-core forms): the block's threads, dtype conversions and loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}
// the value v.astype(T) leaves
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// scalar loads: L2 only (ld.cg) for buffers other blocks write during the
// launch; the read-only path for inputs
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float ld_nc(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_nc(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// 16 bytes -> 4 or 8 floats
__device__ __forceinline__ void unpack16(uint4 v, float* dst, const float*) {
  dst[0] = __uint_as_float(v.x);
  dst[1] = __uint_as_float(v.y);
  dst[2] = __uint_as_float(v.z);
  dst[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(uint4 v, float* dst, const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
template <typename T> __device__ __forceinline__ void load16_nc(const T* p, float* dst) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), dst, p);
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }
