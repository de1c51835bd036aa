// Shared by the fused speller kernels (speller_decode.cu, speller_bwd.cu):
// the block geometry, dtype conversions, loads, and the warp-level dot of a
// few batch rows against weight columns kept in shared memory, with the
// transposing butterfly that sums it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROWS = 2;   // batch rows a warp carries at once in the dot phases
constexpr int MAX_GRID = 128;  // blocks of a launch, at most: a power of two, one per SM
constexpr int MAX_UNITS = 8;   // units of a cell (query columns) a block owns, at most:
                               // the largest case of the phase switches in the kernels
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
template <typename T> __device__ __forceinline__ void load16_cg(const T* p, float* dst) {
  unpack16(__ldcg(reinterpret_cast<const uint4*>(p)), dst, p);
}
template <typename T> __device__ __forceinline__ void load16_nc(const T* p, float* dst) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), dst, p);
}
template <typename T> __device__ __forceinline__ void load16_smem(const T* p, float* dst) {
  unpack16(*reinterpret_cast<const uint4*>(p), dst, p);
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

// acc[i][c] += x[rows[i], 0:len] . w_s[c * w_stride + w_off + (0:len)] over
// this lane's 16-byte slices of x (lane * VEC, + 32 * VEC, ...); x rows are
// len apart. The rows' loads go out together and each weight slice is read
// from shared memory once for all rows.
template <typename T, int NC>
__device__ __forceinline__ void dot_rows(float (*acc)[NC], const T* x, int len, const int* rows,
                                         const T* w_s, int w_stride, int w_off, int lane) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll 2
  for (int k = lane * VEC; k < len; k += 32 * VEC) {
    float xv[ROWS][VEC];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) load16_cg(x + (long long)rows[i] * len + k, xv[i]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float wv[VEC];
      load16_smem(w_s + c * w_stride + w_off + k, wv);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[i][c] = fmaf(xv[i][j], wv[j], acc[i][c]);
    }
  }
}

// The rows a warp carries at once: r0, r0 + NWARPS, ...; a row past the
// batch repeats r0 (computed, never written).
__device__ __forceinline__ void warp_rows(int r0, int B, int* rows, bool* live) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    live[i] = r0 + i * NWARPS < B;
    rows[i] = live[i] ? r0 + i * NWARPS : r0;
  }
}

// Transposing butterfly over the warp: on entry each lane holds N partial
// sums; on exit acc[0] of every lane holds the warp-wide sum of column
// lane >> (5 - log2 N). Each halving step sends half the columns to the
// partner lane and keeps the other half (N - 1 shuffles in all), then plain
// butterflies finish.
template <int N, int O>
__device__ __forceinline__ void halve(float* acc, int lane) {
  if constexpr (N > 1) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = upper ? acc[j] : acc[j + N / 2];
      const float keep = upper ? acc[j + N / 2] : acc[j];
      acc[j] = keep + __shfl_xor_sync(FULL, send, O);
    }
    halve<N / 2, O / 2>(acc, lane);
  } else {
#pragma unroll
    for (int o = O; o >= 1; o >>= 1) acc[0] += __shfl_xor_sync(FULL, acc[0], o);
  }
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }
