// Two further float32 forms of the persistent LSTM recurrence of lstm_scan.cu
// (bfloat16: lstm_scan_tc_streams.cu; the kernel's body is
// lstm_scan_body.cuh; lstm_scan.cu's header says what bounds it and how a
// block is laid out). Both read a precomputed x_proj.
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py):
//   STREAMS_CS: _lstm_scan_kernel with with_cs=True (:98, launched by
//       _forward_pallas at :216) -- the lean recurrence with one more output
//       stream, cs: the carry c after each frame, frozen at padded frames, in
//       the stream dtype. hs is bit-identical to the lean kernel's (zero at
//       padded frames), cs to the training kernel's; no gates are written.
//       Up to H = 1024, one or both directions.
//   STREAMS_BI: _bilstm_scan_kernel (:1063, launched by _forward_pallas_bi
//       at :1143) -- both directions of a BiLSTM layer in ONE cooperative
//       launch over xp (T, 2, B, 4H), whose direction 1 arrives flipped in
//       time as a whole, into hs and cs (T, 2, B, H). It differs from every
//       other form in two ways: hs at a padded frame is the frozen carry
//       itself, not zero; and direction 1's padded frames come FIRST in its
//       stream (frame s of a row of length len is valid iff s >= T - len),
//       where its carry is still zero, so hs = cs = 0 on them, while
//       direction 0's come last and hold the row's last valid h and c.
//       The kernel walks both streams ascending and applies that rule; the
//       wrapper does not hand it a negative time stride. The (T, 2, B, .)
//       layout needs no copy: x and the outputs are addressed by the element
//       strides of ScanArgs. Both directions must be in one launch (H <=
//       512; the wrapper raises for a wider layer, which is
//       bilstm_apply_kernel's, a launch a direction).
//
// What the fused form buys on this card: nothing in the recurrence (the lean
// kernel already runs both directions in one launch); the op around it does
// the two input projections as one product. Its times are in PERF.md.

#include "lstm_scan_body.cuh"

// Shapes are checked by the Python wrapper (ops/lstm_cuda.py), as for
// lstm_scan_launch. dtype: 0 = float32 (bfloat16 is
// lstm_scan_tc_streams_launch's). bi != 0: the fused bidirectional form
// (ndir = 2, rev_bits ignored). Returns a cudaError_t.
extern "C" int lstm_scan_streams_launch(int dtype, int bi, int ndir, int rev_bits, int B, int T,
                                        int H, const void* x, long long x_sd, long long x_sb,
                                        long long x_st, const void* w_hh, const int* lengths,
                                        void* out, long long o_sd, long long o_sb,
                                        long long o_st, void* hbuf, void* cs, int units,
                                        int rows, int stages, void* sync, void* stream) {
  ScanArgs a{x,    x_sd, x_sb,    x_st, nullptr, nullptr, w_hh, lengths, out,      o_sd, o_sb, o_st,
             hbuf, cs,   nullptr, 0,    0,       0,       ndir, rev_bits, B,       T,    0,    H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ctr = static_cast<unsigned*>(sync);
  if (dtype != 0 || !f32_geometry_ok(a, units, rows, stages)) return (int)cudaErrorInvalidValue;
  if (bi) {
    if (a.ndir != 2) return (int)cudaErrorInvalidValue;
    a.rev_bits = 0;
    return launch<false, STREAMS_BI>(a, units, rows, stages, ctr, s);
  }
  return launch<false, STREAMS_CS>(a, units, rows, stages, ctr, s);
}
