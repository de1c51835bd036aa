// Persistent LSTM recurrence for Hopper (sm_90a), bfloat16, with the
// recurrent dot on tensor cores (wgmma.m64nNk16, bf16 operands from shared
// memory, fp32 accumulators): one cooperative launch runs the whole time loop
// of one listener layer for up to 128 batch rows and both directions.
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py), in bf16:
//   FUSED_IN = false: _lstm_scan_nocs_kernel (:87), launched by
//       _forward_pallas(with_cs=False) -- pre_t = x_proj[t] + h_{t-1} @ W_hh;
//   FUSED_IN = true:  _lstm_scan_fusedin_kernel (:854), launched by
//       _fusedin_call(train=False) -- pre_t = (x_t @ W_ih + b) + h_{t-1} @ W_hh,
//       the narrow input projection computed in the kernel (in_dim <= 128);
//   STREAMS_TRAIN: the training forward of either, _lstm_scan_train_kernel
//       (:239, launched by _forward_pallas_train) and _fusedin_call(train=True)
//       -- the same recurrence with cs (the carry after each frame, frozen at
//       padded frames) and the activated gates [i, f, g, o] (zero at padded
//       frames) for the adjoint kernel (lstm_bwd.cu). hs is bit-identical to
//       the lean form's: one body, one summation order.
// float32 runs on lstm_scan.cu (CUDA-core FMAs, tolerance 1e-4 against the
// plain version, which TF32 tensor cores would not keep).
//
// Numerics are the float32 body's: h and c carried in fp32, h rounded to bf16
// only as the operand of the recurrent dot, fp32 accumulation (a bf16 x bf16
// product is exact in fp32, so only the order of the sum differs), fp32 gates,
// the carry frozen where t >= length, h written as zero at padded frames,
// outputs in bf16. A reverse direction walks time descending from a zero carry.
//
// What bounds it: every step depends on the previous step's h, so a layer
// costs T x (waiting for the direction's other blocks + reading h from L2 +
// this block's share of the (B, H) x (H, 4H) product + the gates). The
// float32 body (lstm_scan.cu) runs one lane a batch row (32 rows a launch),
// keeps W_hh as fp32 (8 units a block, 2 x 128 blocks at H = 1024, so a launch
// a direction) and does the dot on CUDA-core FMAs with a grid-wide barrier a
// step: at scaled-LAS (H = 1024, B = 128) eight dependent chains of T steps of
// ~19 us each. Here: W_hh as bf16 (128 KB a block at H = 1024 with 16 units,
// 32 KB at H = 512 with 8), so both directions fit 128 blocks at every width
// up to 1024; all 128 rows in one block, h streamed through a cp.async ring;
// the dot on tensor cores; a barrier per direction instead of per grid, with
// the next step's input term computed while the block waits. One chain of T
// steps a layer. What is left of a step is the L2 traffic of h (at H = 1024,
// B = 128 the 128 blocks read 32 MB of h a step), the tensor-core products,
// the gates of U x B cells a block, and the per-direction barrier; PERF.md
// has the measured step times. wgmma and not mma.sync: an mma.sync.m16n8k16 +
// ldmatrix version on the same swizzled tiles was slower at H = 1024, B = 128
// (its fragments go through registers).
//
// The kernel's body is lstm_scan_tc_body.cuh; this source instantiates its
// lean and training forms, lstm_scan_tc_streams.cu the hs + cs form and the
// fused bidirectional form (kernels #3 and #7), so that the two build side by
// side.

#include "lstm_scan_tc_body.cuh"

// lstm_scan_launch's arguments (dtype must be 1, bfloat16), then the plan's
// hidden units a block (8 or 16) and `sync`, ndir zeroed 32-bit counters (one a
// direction) that the blocks arrive on. hbuf is (2, ndir, B, H) bf16.
// Returns a cudaError_t (0 on success).
extern "C" int lstm_scan_tc_launch(int dtype, int fused, int train, int ndir, int rev_bits, int B,
                                   int T, int D, int H, const void* x, long long x_sd,
                                   long long x_sb, long long x_st, const void* w_ih,
                                   const void* bias, const void* w_hh, const int* lengths,
                                   void* out, long long o_sd, long long o_sb, long long o_st,
                                   void* hbuf, void* cs, void* gates, long long g_sd,
                                   long long g_sb, long long g_st, int units, void* sync,
                                   void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  ScanArgs a{x,    x_sd, x_sb,  x_st, w_ih,     bias, w_hh, lengths, out,  o_sd, o_sb, o_st,
             hbuf, cs,   gates, g_sd, g_sb,     g_st, ndir, rev_bits, B,   T,    D,    H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ctr = static_cast<unsigned*>(sync);
  if (train)
    return fused ? tc_dispatch<true, STREAMS_TRAIN>(units, a, ctr, s)
                 : tc_dispatch<false, STREAMS_TRAIN>(units, a, ctr, s);
  return fused ? tc_dispatch<true, STREAMS_HS>(units, a, ctr, s)
               : tc_dispatch<false, STREAMS_HS>(units, a, ctr, s);
}
