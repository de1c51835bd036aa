// Shared by the LSTM recurrence kernels (lstm_scan.cu, lstm_scan_streams.cu,
// lstm_scan_tc.cu, lstm_scan_tc_streams.cu, lstm_bwd.cu, lstm_bwd_tc.cu): the
// fixed block geometry of the float32 adjoint (the float32 forward's is in
// lstm_scan_body.cuh), dtype conversions, the
// forward recurrence's arguments and output forms, and the loader that stages
// rows of a (rows, H) slab from global memory into padded float32 shared
// memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int UNITS = 8;     // hidden units per block
constexpr int NWARPS = 8;    // k-split of the recurrent dot
constexpr int NTHREADS = NWARPS * 32;
constexpr int BMAX = 32;     // batch rows: one per lane
constexpr int LOAD_BATCH = 8;  // 16-byte loads in flight per thread
// Above this hidden size a (BMAX, H) slab no longer fits in shared memory
// beside a block's weights: the kernels stage it in two halves.
constexpr int WIDE_FROM = 512;

constexpr int STREAMS_HS = 0;
constexpr int STREAMS_TRAIN = 1;
constexpr int STREAMS_CS = 2;
constexpr int STREAMS_BI = 3;

struct ScanArgs {
  const void* x;        // FUSED_IN: (B, T, D) input; else (B, T, ndir*4H) x_proj
  long long x_sd, x_sb, x_st;   // element strides: direction, batch, time
  const void* w_ih;     // FUSED_IN: (ndir, D, 4H)
  const void* bias;     // FUSED_IN: (ndir, 4H)
  const void* w_hh;     // (ndir, H, 4H)
  const int* lengths;   // (B,)
  void* out;            // (B, T, ndir*H)
  long long o_sd, o_sb, o_st;
  void* hbuf;           // (2, ndir, B, H) exchange buffer, weight dtype
  void* cs;             // all but STREAMS_HS: (B, T, ndir*H), out's strides
  void* gates;          // STREAMS_TRAIN: (B, T, ndir*4H)
  long long g_sd, g_sb, g_st;
  int ndir, rev_bits, B, T, D, H;
};

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// 16 bytes -> 4 or 8 floats at a 16-byte aligned dst
__device__ __forceinline__ void unpack16(uint4 v, float* dst, const float*) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&v);
}
__device__ __forceinline__ void unpack16(uint4 v, float* dst, const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  const float2 c = __bfloat1622float2(p[2]), e = __bfloat1622float2(p[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, e.x, e.y);
}

// Rows [0, rows) of `width` elements each, `src_row_stride` elements apart in
// global memory, into dst[row * dst_stride + col] as float32. 16-byte loads
// that bypass L1 (other blocks of the launch may have written the source),
// all of a batch issued before any is converted. `src`, the row stride and
// `width` must keep every row 16-byte aligned. A row of a power-of-two
// number of 16-byte chunks (every H that is 32 times a power of two) is
// split with a shift instead of a division: this runs in the recurrence's
// critical path.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int dst_stride, const T* src,
                                           long long src_row_stride, int rows, int width) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  const int chunks_per_row = width / VEC;
  const int n_chunks = rows * chunks_per_row;
  const bool pow2 = (chunks_per_row & (chunks_per_row - 1)) == 0;
  const int shift = 31 - __clz(chunks_per_row);
  for (int base = threadIdx.x; base < n_chunks; base += NTHREADS * LOAD_BATCH) {
    uint4 buf[LOAD_BATCH];
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int c = base + j * NTHREADS;
      if (c < n_chunks) {
        const int r = pow2 ? (c >> shift) : (c / chunks_per_row);
        buf[j] = __ldcg(reinterpret_cast<const uint4*>(src + (long long)r * src_row_stride) +
                        (c - r * chunks_per_row));
      }
    }
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int c = base + j * NTHREADS;
      if (c < n_chunks) {
        const int r = pow2 ? (c >> shift) : (c / chunks_per_row);
        unpack16(buf[j], dst + r * dst_stride + (c - r * chunks_per_row) * VEC,
                 static_cast<const T*>(nullptr));
      }
    }
  }
}
