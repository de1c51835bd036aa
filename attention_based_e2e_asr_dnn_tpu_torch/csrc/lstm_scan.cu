// Persistent LSTM recurrence for Hopper (sm_90a), float32: one cooperative
// launch runs the whole time loop of one listener layer, one or both
// directions, for up to 32 batch rows. bfloat16 runs on tensor cores in
// lstm_scan_tc.cu (all rows up to 128 and both directions in one launch).
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py), in float32:
//   FUSED_IN = false: _lstm_scan_nocs_kernel (:87), launched by
//       _forward_pallas(with_cs=False) -- pre_t = x_proj[t] + h_{t-1} @ W_hh;
//   FUSED_IN = true:  _lstm_scan_fusedin_kernel (:854), launched by
//       _fusedin_call(train=False) -- pre_t = (x_t @ W_ih + b) + h_{t-1} @ W_hh,
//       the narrow input projection computed in the kernel (in_dim <= 128);
//   TRAIN = true: the training forward of either, _lstm_scan_train_kernel
//       (:239, launched by _forward_pallas_train) and _fusedin_call(train=True)
//       -- the same recurrence with two more output streams for the adjoint
//       kernel (lstm_bwd.cu): cs, the carry c after each frame (at a padded
//       frame the frozen carry, not zero), and the activated gates [i, f, g, o]
//       rounded to the stream dtype (zero at padded frames, where the adjoint
//       ignores them). hs is bit-identical to the TRAIN = false kernels'.
//
// Numerics follow the TPU kernels: h and c carried in fp32, h rounded to the
// weight dtype only as the operand of the recurrent dot, fp32 accumulation,
// fp32 gates [i, f, g, o], the carry frozen where t >= length, h written as
// zero at padded frames, outputs in the input dtype. A reverse direction
// walks time descending from a zero carry, so every row starts at its own
// last valid frame.
//
// What bounds it: every step depends on the previous step's h, so a layer
// costs T x (one grid-wide barrier + reading h from L2 + this block's share
// of the (B, H) x (H, 4H) product + the gates). At H = 512, B = 32 that share
// is 0.5M FMAs per block per step. The kernel is latency-bound, not
// bandwidth-bound: on an H100 (700 W power limit) a step takes ~11 us, of
// which removing the dot saves ~5 us and the grid barrier ~2 us (PERF.md).
//
// Design. A persistent grid of ndir * H / UNITS blocks (128 blocks at
// H = 512 with both directions, on 132 SMs; a layer too wide for that, as
// H = 1024 with its 2 x 128 blocks, is launched once a direction by the
// wrapper: the directions are independent, and one block an SM keeps the
// whole of shared memory for the block's W_hh columns). Block j of direction d owns
// hidden units [UNITS*j, UNITS*j + UNITS) and keeps their four gates' columns
// of W_hh (H x 4*UNITS, as fp32) in shared memory for the whole sequence.
// Thread (warp u, lane b) owns batch row b of unit u and keeps its c and h in
// registers. Each step:
//   1. the block copies h_{t-1} (B x H, already rounded to the weight dtype)
//      from a double-buffered global exchange buffer into shared memory;
//   2. warp w computes partial dots over k in [w*H/8, (w+1)*H/8) for its lane's
//      batch row and all UNITS x 4 columns (32 fp32 accumulators a thread);
//   3. the partials are summed across the 8 warps through shared memory;
//   4. thread (u, b) applies the gates, updates its carry, writes its output
//      and its rounded h into the other half of the exchange buffer;
//   5. one grid-wide barrier (cooperative groups) publishes h_t.
// WIDE = true (512 < H <= 1024): the block's W_hh columns alone take
// H x 32 x 4 bytes (128 KB at H = 1024), so h_{t-1} no longer fits beside
// them in one piece (32 x (H + 4) x 4 bytes more would pass the 227 KB a
// block may use). Steps 1 and 2 then run twice, over one half of the k range
// at a time (66 KB of staging at H = 1024, 194 KB in all). WIDE = false is
// the single pass, as compiled before there was a wide form.
// The cooperative launch refuses a grid that cannot be co-resident, so a
// shape too wide for the card fails at launch instead of deadlocking.
// Plain FMA on the CUDA cores, which keeps float32's 1e-4 tolerance against
// the plain version (TF32 tensor cores would not).
//
// The kernel's body is lstm_scan_body.cuh; this source instantiates its lean
// and training forms, lstm_scan_streams.cu the hs + cs form and the fused
// bidirectional form (kernels #3 and #7), so that the two build side by side.

#include "lstm_scan_body.cuh"

// Shapes are checked by the Python wrapper (ops/lstm_cuda.py): B <= 32,
// H % 32 == 0 up to 512 and H % 64 == 0 from there to 1024 (the wide form),
// ndir * H / 8 blocks no more than the card's SMs, D <= 128 for the fused
// input. A grid that still cannot be co-resident (shared memory)
// is refused by the cooperative launch and reported here.
// dtype: 0 = float32 (bfloat16 is lstm_scan_tc_launch's). train != 0 also
// writes cs and gates.
// Returns a cudaError_t (0 on success).
template <typename T, bool WIDE>
static cudaError_t dispatch_form(int fused, int train, ScanArgs a, cudaStream_t s) {
  if (train)
    return fused ? launch<T, true, STREAMS_TRAIN, WIDE>(a, s)
                 : launch<T, false, STREAMS_TRAIN, WIDE>(a, s);
  return fused ? launch<T, true, STREAMS_HS, WIDE>(a, s)
               : launch<T, false, STREAMS_HS, WIDE>(a, s);
}

template <typename T>
static cudaError_t dispatch(int fused, int train, ScanArgs a, cudaStream_t s) {
  if (a.H > WIDE_FROM) return dispatch_form<T, true>(fused, train, a, s);
  return dispatch_form<T, false>(fused, train, a, s);
}

extern "C" int lstm_scan_launch(int dtype, int fused, int train, int ndir, int rev_bits, int B,
                                int T, int D, int H, const void* x, long long x_sd,
                                long long x_sb, long long x_st, const void* w_ih,
                                const void* bias, const void* w_hh, const int* lengths,
                                void* out, long long o_sd, long long o_sb, long long o_st,
                                void* hbuf, void* cs, void* gates, long long g_sd,
                                long long g_sb, long long g_st, void* stream) {
  ScanArgs a{x,    x_sd, x_sb, x_st,  w_ih, bias, w_hh, lengths, out,      o_sd, o_sb, o_st,
             hbuf, cs,   gates, g_sd, g_sb, g_st, ndir, rev_bits, B,       T,    D,    H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(fused, train, a, s);
  return (int)cudaErrorInvalidValue;
}
