// Two further bfloat16 forms of the tensor-core LSTM recurrence of
// lstm_scan_tc.cu (the body is lstm_scan_tc_body.cuh; lstm_scan_tc.cu's header
// says what bounds it and how a block is laid out). Both read a precomputed
// x_proj.
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py), in bf16:
//   STREAMS_CS: _lstm_scan_kernel with with_cs=True (:98, launched by
//       _forward_pallas at :216) -- the lean recurrence with the carry stream
//       cs; hs bit-identical to lstm_scan_tc.cu's lean form, cs to its training
//       form. Up to H = 1024, one or both directions.
//   STREAMS_BI: _bilstm_scan_kernel (:1063, launched by _forward_pallas_bi at
//       :1143) -- both directions of a BiLSTM layer over xp (T, 2, B, 4H),
//       direction 1 flipped in time as a whole (frame s of a row of length len
//       is valid iff s >= T - len), hs the frozen carry at padded frames, cs;
//       both (T, 2, B, H), addressed by ScanArgs' strides. H <= 512 (the
//       wrapper's limit, kept from the float32 form: a wider layer is
//       bilstm_apply_kernel's).
// float32 runs on lstm_scan_streams.cu.

#include "lstm_scan_tc_body.cuh"

// lstm_scan_streams_launch's arguments (dtype must be 1, bfloat16), then the
// plan's hidden units a block and the zeroed per-direction counters, as
// lstm_scan_tc_launch. bi != 0: the fused bidirectional form (ndir = 2,
// rev_bits ignored). Returns a cudaError_t.
extern "C" int lstm_scan_tc_streams_launch(int dtype, int bi, int ndir, int rev_bits, int B,
                                           int T, int H, const void* x, long long x_sd,
                                           long long x_sb, long long x_st, const void* w_hh,
                                           const int* lengths, void* out, long long o_sd,
                                           long long o_sb, long long o_st, void* hbuf, void* cs,
                                           int units, void* sync, void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  ScanArgs a{x,    x_sd, x_sb,    x_st, nullptr, nullptr, w_hh, lengths, out,      o_sd, o_sb, o_st,
             hbuf, cs,   nullptr, 0,    0,       0,       ndir, rev_bits, B,       T,    0,    H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ctr = static_cast<unsigned*>(sync);
  if (bi) {
    if (a.H > WIDE_FROM || a.ndir != 2) return (int)cudaErrorInvalidValue;
    a.rev_bits = 0;
    return tc_dispatch<false, STREAMS_BI>(units, a, ctr, s);
  }
  return tc_dispatch<false, STREAMS_CS>(units, a, ctr, s);
}
