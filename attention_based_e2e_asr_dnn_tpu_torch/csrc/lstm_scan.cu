// Persistent LSTM recurrence for Hopper (sm_90a), float32: one cooperative
// launch runs the whole time loop of one listener layer, every batch row
// the card can hold at once and one or both directions. bfloat16 runs on
// tensor cores in lstm_scan_tc.cu (all rows up to 128 and both directions in
// one launch).
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
// last valid frame. Plain fmaf on the CUDA cores, no TF32: float32 keeps its
// 1e-4 tolerance against the plain version (TF32 tensor cores would not).
//
// What bounds it: every step depends on the previous step's h, so a layer
// costs T x (the wait for h_{t-1} + staging it + this block's share of the
// (B, H) x (H, 4H) product + the gates). At the Rewriter's H = 256, B = 256,
// both directions, that product is 134M FMAs a step, ~4 us at the card's
// 67 TFLOP/s float32 peak; every block reads its rows of h_{t-1} from L2
// (8.4 MB a step over the card); and the blocks of a row group meet once a
// step. The design's answers, in that order:
//   - the product: every SM busy and every FMA from registers. A block owns
//     R batch rows x U hidden units (4U gate columns) of one direction, so a
//     launch holds every row and both directions (R = 64, U = 16 at H = 256,
//     B = 256: 2 x 4 x 16 = 128 blocks of 256 threads; the Python plan picks
//     R and U from B, H, the directions and the card's SMs). Its W_hh
//     columns (H x 4U, 64 KB there) stay in shared memory for the whole
//     sequence; each thread keeps a 4-row x 4-gate tile of one unit in
//     registers over the whole k range (16 FMAs for two 16-byte shared
//     loads, no cross-warp reduction) and applies the gates to it directly;
//   - the staging: h_{t-1}'s R rows stream through a ring of up to four
//     64-column stages (cp.async, L2 only), the next chunks in flight while
//     one is multiplied; the step's input term (the x_proj entries, or the
//     narrow input projection under FUSED_IN) is computed before the wait,
//     while the other blocks finish;
//   - the meeting: one release-counter a (direction, row group), the grid
//     barrier restricted to the H / U blocks that exchange h (16 at the
//     Rewriter's width), polled by one thread with an acquire load.
// A batch whose row groups the card cannot hold at once takes more launches,
// one after another (the only split); so does a layer whose directions
// together need more blocks than the card has SMs (H = 1024: a launch a
// direction). The cooperative launch refuses a grid that cannot be
// co-resident, so a shape too wide for the card fails at launch instead of
// deadlocking.
//
// The kernel's body is lstm_scan_body.cuh; this source instantiates its lean
// and training forms, lstm_scan_streams.cu the hs + cs form and the fused
// bidirectional form (kernels #3 and #7), so that the two build side by side.

#include "lstm_scan_body.cuh"

// Shapes are checked by the Python wrapper (ops/lstm_cuda.py::plan_launches):
// H a multiple of 32 up to 1024, D <= 128 for the fused input, the geometry
// (units, rows, stages) of f32_geometry_ok; a grid that still cannot be
// co-resident is refused by the cooperative launch and reported here.
// dtype: 0 = float32 (bfloat16 is lstm_scan_tc_launch's). train != 0 also
// writes cs and gates. sync: ndir x ceil(B / rows) zeroed counters.
// Returns a cudaError_t (0 on success).
extern "C" int lstm_scan_launch(int dtype, int fused, int train, int ndir, int rev_bits, int B,
                                int T, int D, int H, const void* x, long long x_sd,
                                long long x_sb, long long x_st, const void* w_ih,
                                const void* bias, const void* w_hh, const int* lengths,
                                void* out, long long o_sd, long long o_sb, long long o_st,
                                void* hbuf, void* cs, void* gates, long long g_sd,
                                long long g_sb, long long g_st, int units, int rows,
                                int stages, void* sync, void* stream) {
  ScanArgs a{x,    x_sd, x_sb, x_st,  w_ih, bias, w_hh, lengths, out,      o_sd, o_sb, o_st,
             hbuf, cs,   gates, g_sd, g_sb, g_st, ndir, rev_bits, B,       T,    D,    H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ctr = static_cast<unsigned*>(sync);
  if (dtype != 0 || !f32_geometry_ok(a, units, rows, stages)) return (int)cudaErrorInvalidValue;
  if (train)
    return fused ? launch<true, STREAMS_TRAIN>(a, units, rows, stages, ctr, s)
                 : launch<false, STREAMS_TRAIN>(a, units, rows, stages, ctr, s);
  return fused ? launch<true, STREAMS_HS>(a, units, rows, stages, ctr, s)
               : launch<false, STREAMS_HS>(a, units, rows, stages, ctr, s);
}
