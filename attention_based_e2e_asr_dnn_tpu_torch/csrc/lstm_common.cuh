// Shared by the LSTM recurrence kernels (lstm_scan.cu, lstm_scan_streams.cu,
// lstm_scan_tc.cu, lstm_scan_tc_streams.cu, lstm_bwd.cu, lstm_bwd_tc.cu):
// dtype conversions and the forward recurrence's arguments and output forms.
// Each body keeps its own block geometry (lstm_scan_body.cuh,
// lstm_scan_tc_body.cuh, lstm_bwd.cu, lstm_bwd_tc_body.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The widest layer of the fused bidirectional form (lstm_scan_tc_streams.cu)
// and of the adjoint with dW_hh in the kernel.
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
