// The bfloat16 fused speller decode for Hopper (sm_90a), with the batch rows
// of its three products on tensor cores (wgmma, bf16 operands from shared
// memory, fp32 accumulators) and their inputs streamed by TMA: one
// cooperative launch runs every step of the decode for up to 128 batch rows,
// in an eval and a training form of one body.
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/speller_pallas.py), in bf16:
//   _decode_fwd_kernel (:90) as _fwd_chunk (:465, the call at :493) launches
//   it: TPU kernel #8. TRAIN = false is the eval form (save_residuals=False);
//   TRAIN = true the training form (save_residuals=True: the dropout masks
//   on the cells' outputs and the residual streams of the adjoint). float32
//   runs on speller_decode.cu (CUDA-core FMAs, the same steps).
//
// What it computes is speller_decode.cu's, with the numerics of the Pallas
// kernel and of ops/speller_cuda.py's plain version: carries h1, c1, h2, c2
// and ctx in fp32, rounded to bf16 only as dot operands; fp32 accumulation
// and fp32 gates; the attention's products formed in fp32 from bf16-rounded
// operands and summed in fp32; the classifier over cat(q, ctx) rounded to
// bf16; the feedback is the first maximum of the fp32 logits. Two things
// are summed in another order than there: the fed id's row of embw1 enters
// cell 1's product as one more 64-wide k-chunk against the id's one-hot
// (exact in bf16, summed into the fp32 accumulators), and the k-chunks of
// each product run [h_prev; input] (cell 2) and [h1_prev; ctx; one-hot]
// (cell 1).
//
// What bounds it on this card. A step is four dependent phases: cell 1,
// cell 2, the query, then per batch row the attention, the classifier and
// the argmax that is the next step's input. Its work is tiny (at base-LAS,
// B=128, ~0.62 GFLOP a step, under a microsecond of the tensor cores), so a
// step costs the latency of its hand-offs between blocks and of each
// phase's chain. The float32 body (speller_decode.cu) walks the batch two
// rows a warp on the CUDA cores in each product phase, so its step grows by
// ~0.55 us a row at base-LAS (PERF.md: ~70% of a B=128 step), and
// ends each phase with a grid barrier.
//
// What the design does about it:
//   * Geometry. G blocks, the largest power of two up to 128 (and the card's
//     SMs) that divides H1 and H2 (128 at base- and scaled-LAS; 288
//     threads: two consumer warpgroups and a producer warp). Block g owns U1
//     = H1 / G units of cell 1 (1 to 8) and U2 = H2 / G of cell 2 (1 to 4),
//     the four gates of a unit side by side (column n = 4u + gate), and
//     keeps those columns of [whh1; wc1; embw1] and [whh2; wih2] as bf16 in
//     shared memory for the whole launch, K-major, 64 k a 128-byte row with
//     the 128-byte swizzle. A product's N = 8 NC, NC = ceil(U / 2) (the
//     template's NC1, NC2): where 4U is not a multiple of 8 (U odd) the last
//     four columns are zero weights and their unit is not stored. Keeping G
//     at 128 keeps the cell-1 tile within the card at H1 = 1024 (21 k-chunks
//     x 32 columns x 128 B = 86 KB); G = H2 / 2 would give 64 blocks of 16
//     units there (172 KB) at H2 = 128.
//   * The query. wgmma's N is a multiple of 8, and P / G = 2 columns a block
//     would not be one; the query's P columns go 8 a block to the first
//     P / 8 blocks (32 at P = 256; so P <= 8 G), the same product as the
//     cells'. Left on the CUDA cores it would walk the rows again; folded into
//     the attention (the block of row r forming q_r itself) every block would
//     read all of wq each step, 128 KB at base-LAS, more than the row's K (96
//     KB), whose scores take ~4.5 us of a step (PERF.md). On tensor cores it
//     is a few k-steps and one more hand-off.
//   * Products. Each phase's input streams from its exchange buffer in
//     64-column boxes through a ring of shared-memory stages, loaded by TMA
//     from one producer thread and completing on the stage's `full`
//     mbarrier; a consumer warp releases a stage through its `empty`
//     mbarrier once its products on it are done. The producer runs ahead as
//     far as the ring and the data allow: h1_prev for the next cell 1 loads
//     during the attention. Past 64 rows each warpgroup takes 64 rows over
//     all k; up to 64 rows both take the same rows and split the k-chunks.
//   * Gates. The warpgroups' sums meet in a shared-memory tile and a thread
//     adds them in the fixed order warpgroup 0 + warpgroup 1: no atomics and
//     no k split across blocks, so two runs repeat bit for bit and the
//     training form without masks and forcing is bit-equal to the eval form.
//     A thread owns NC unit slots of one row of each cell (slots NC h ..
//     NC h + NC - 1 of the block's units, h = its half) for the whole launch
//     and keeps their fp32 c carries in registers; a slot past U is idle.
//   * Attention (per row, as speller_decode.cu): block r takes batch row r
//     (r += G): scores, softmax (NWARPS / heads warps a head), context,
//     classifier and first-max argmax; it writes the next step's fed id (a
//     forced id >= 0, else the argmax) as a one-hot row into the exchange
//     that cell 1 reads. The row's residual streams (gates, c) are stored
//     after a cell's publish: no block reads them during the launch.
//   * Streamed cell-1 weights (STREAM). Where the resident tiles with the
//     fixed buffers leave the ring fewer than DT_MIN_STAGES stages even of 64
//     rows (H1 896-1024 with H2 256-512 and P 640-1024: the cell-1 tile alone
//     is up to 132 KB), cell 1's weight columns stream through the ring
//     instead: each of its stages carries the input box and, behind it, the
//     block's N1 weight rows of the same 64 k (a TMA box of the K-major copy
//     ops/speller_cuda.py::stream_weights lays out, in the resident tile's
//     order), both on the stage's `full` mbarrier, as speller_bwd_tc.cu
//     streams its weights. Cell 2 and the query stay resident. The products,
//     their k order and their sums are the resident form's, so the two forms
//     give the same bits.
//   * Synchronisation. No grid barrier: four monotonic counters, one a phase,
//     each block adding one (release) when its part of the phase is stored,
//     waited for (acquire) by one thread of a block. Writes that other
//     blocks read through TMA are fenced to the async proxy before the
//     release and after the acquire.
//
// The exchanges and who waits for what. Value s of a stream (s = -1 the
// state before the first step, written at the start of the launch by the
// blocks that own it) lives in slot (s + 1) & 1 of a (2, rows, X) buffer in
// the eval form and in slot s + 1 of a (T + 1, rows, X) stream in the
// training form, whose slots 1.. are the residual streams h1d, h2d and
// ctx; the fed id's one-hot of step t in slot t & 1. Counter targets are in
// units of blocks (nqb = P / 8 for the query):
//   cell 1 (t) waits CELL1 >= (t + 1) G  (h1_{t-1}),
//              ATTEND >= (t + 1) G (ctx_{t-1}, the one-hot of step t);
//   cell 2 (t) waits CELL2 >= (t + 1) G  (h2_{t-1}), CELL1 >= (t + 2) G (h1_t);
//   query (t)  waits CELL2 >= (t + 2) G  (h2_t);
//   attend (t) waits QUERY >= (t + 1) nqb (q_t).
// Write-after-read: each slot is written again two steps later, and every
// write of step t + 2 (or of the single q buffer at t + 1) comes after its
// block passed ATTEND of a later step than the reads, so after every block
// finished reading it: the eval form's h1 slot of h1_{t-2} (read by cell 1
// (t - 1) and cell 2 (t - 2)) is rewritten by cell 1 (t), which waited for
// ATTEND (t - 1); its ctx slot of ctx_{t-2} (read by cell 1 (t - 1)) by
// attend (t), after QUERY (t) <- CELL2 (t) <- CELL1 (t) of every block; the
// q buffer (read by attend (t)) by the query (t + 1), after CELL2 (t + 1) <-
// CELL1 (t + 1) <- ATTEND (t); the one-hot of step t + 2 by attend (t + 1),
// after cell 1 (t + 1) of every block and so after cell 1 (t).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): a step of
// ~23 us at B=64 (eval) and ~30 us at B=128 (train; base-LAS), where the
// bf16 form of the float32 body took 51 and 96 us, and nearly flat in B up
// to 128 rows. About half of it is the attention of one row a block (~12
// us: its scores and context ~4.5 us each), the rest the three hand-offs
// and epilogues of the products; the products themselves are well under a
// microsecond (tools/trace_speller_decode.py splits a step).

#include "speller_common.cuh"
#include "wgmma_common.cuh"

constexpr int DT_CONSUMERS = NTHREADS;          // two warpgroups (the attention's threads)
constexpr int DT_THREADS = DT_CONSUMERS + 32;   // and the producer warp
constexpr int DT_ROWS = 128;                    // batch rows a launch
constexpr int DT_MAX_GRID = 128;                // blocks, at most: one per SM
constexpr int DT_MAX_UNITS1 = 8;                // cell-1 units a block, at most (N = 32)
constexpr int DT_MAX_UNITS2 = 4;                // cell-2 units a block, at most (N = 16)
constexpr int DT_KC = 64;                       // columns of a ring stage: one TMA box
constexpr int DT_SEL = 64;                      // the one-hot's width (Vp <= DT_VMAX used)
constexpr int DT_QCOLS = 8;                     // query columns of a query block (N = 8)
constexpr int DT_VMAX = 32;                     // padded vocabulary: one lane per entry
constexpr int DT_MAX_STAGES = 8;
constexpr int DT_MIN_STAGES = 4;
constexpr int DT_BAR_BYTES = 2 * DT_MAX_STAGES * 8;
enum Ctr { C_CELL1, C_CELL2, C_QUERY, C_ATTEND, N_CTRS };

// Phase stamps for tools/trace_speller_decode.py. Built with -DDT_TRACE, thread
// 0 (and the producer's lane 0, its two) of blocks 0, G / 2 and G - 1 write
// %globaltimer at each phase boundary of the first DT_TRACE_STEPS steps (the
// last of a block's rows where it has several); without it DT_STAMP is
// nothing and the kernels are the same.
enum Stamp {
  S_STEP, S_CELL1_PRODUCT, S_CELL1_PUBLISHED, S_CELL2_PRODUCT, S_CELL2_PUBLISHED,
  S_QUERY_PUBLISHED, S_QUERY_ACQUIRED, S_Q_LOADED, S_SCORES, S_SOFTMAX, S_CONTEXT,
  S_CLASSIFIER, S_ATTEND_PUBLISHED, S_PRODUCER_ATTEND, S_PRODUCER_CELL1, N_STAMPS
};
#ifdef DT_TRACE
constexpr int DT_TRACE_STEPS = 1024;
__device__ unsigned long long dt_trace[3][N_STAMPS][DT_TRACE_STEPS];
__device__ __forceinline__ void dt_stamp(int e, int t) {
  const int b = blockIdx.x == 0 ? 0 : blockIdx.x == gridDim.x / 2 ? 1
                                    : blockIdx.x == gridDim.x - 1 ? 2 : -1;
  if (b < 0 || t >= DT_TRACE_STEPS || (threadIdx.x != 0 && threadIdx.x != DT_CONSUMERS)) return;
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  dt_trace[b][e][t] = v;
}
// the stamps, (3, N_STAMPS, DT_TRACE_STEPS) uint64 nanoseconds (0: not
// written), into `out`; then zeroed
extern "C" int speller_decode_tc_trace(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, dt_trace, sizeof(dt_trace));
  void* p = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, dt_trace);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(dt_trace));
  return (int)err;
}
#define DT_STAMP(e, t) dt_stamp(e, t)
#else
#define DT_STAMP(e, t)
#endif

// pointer slots of the launch (the order of ops/speller_cuda.py's list)
enum TcPtr {
  T_K, T_V, T_BIAS, T_CTX0, T_H10, T_C10, T_H20, T_C20, T_EMBW1, T_WC1, T_WHH1, T_WIH2,
  T_WHH2, T_B2, T_WQ, T_BQ, T_WCLS, T_CLSB, T_FORCED, T_LOGITS, T_WGTS, T_IDS,
  T_H1X, T_H2X, T_CTXX, T_SELX, T_QX,
  // the training form's masks (null: no dropout) and residual streams
  T_M1, T_M2, T_SEL, T_GATES1, T_C1R, T_GATES2, T_C2R,
  // the streamed form's cell-1 weights, (G N1, H1 + P + DT_SEL) K-major (null:
  // the resident form)
  T_W1S, N_TC_PTRS
};
// int slots
enum TcDim { E_B, E_LDB, E_TE, E_T, E_P, E_HEADS, E_H1, E_H2, E_VP, E_SOS, E_G, N_TC_DIMS };

struct DecodeTcArgs {
  const void* p[N_TC_PTRS];
  int B, ldb, Te, T, P, heads, H1, H2, Vp, sos;  // ldb: the batch the pointers' rows are in
  float scale;
};

// The block's shared memory, in this order after the slack that puts it on
// a 1024-byte boundary: the weight tiles of cell 1 (N1 = 8 NC1 columns, K =
// H1 + P + DT_SEL; not in the streamed form), cell 2 (N2 = 8 NC2 columns, K
// = H2 + H1) and the query (8 columns, K = H2); the ring, stages of the
// launch's rows rounded up to 64 (64 or 128) x 64 columns, then in the
// streamed form N1 weight rows x 64 k; the gate tile (128 rows x the widest
// N + 8 fp32); the attention's fp32 buffers (q, ctx, classifier partials,
// the context's group sums, the scores of every head); the mbarriers. The
// ring takes what the rest leaves of TC_SMEM_LIMIT, at most DT_MAX_STAGES.
__host__ __device__ inline int dt_box_rows(int B) { return B > 64 ? 128 : 64; }
__host__ __device__ inline size_t dt_w1_bytes(int H1, int P, int NC1) {
  return (size_t)((H1 + P + DT_SEL) / DT_KC) * 8 * NC1 * 128;
}
__host__ __device__ inline size_t dt_w_bytes(int H1, int H2, int P, int NC1, int NC2,
                                             bool stream) {
  return (stream ? 0 : dt_w1_bytes(H1, P, NC1)) + (size_t)((H2 + H1) / DT_KC) * 8 * NC2 * 128 +
         (size_t)(H2 / DT_KC) * DT_QCOLS * 128;
}
__host__ __device__ inline size_t dt_red_bytes(int NC1, int NC2) {
  return (size_t)DT_ROWS * (8 * (NC1 > NC2 ? NC1 : NC2) + 8) * sizeof(float);
}
__host__ __device__ inline size_t dt_att_bytes(int Te, int P, int heads) {
  return align16((2 * (size_t)P + NWARPS * DT_VMAX + NTHREADS * 8 + (size_t)heads * Te) *
                 sizeof(float));
}
// the input box of a stage, and the stage (the input box, then in the
// streamed form the N1 weight rows of its 64 k)
__host__ __device__ inline size_t dt_box_bytes(int B) { return (size_t)dt_box_rows(B) * 128; }
__host__ __device__ inline size_t dt_stage_bytes(int B, int NC1, bool stream) {
  return dt_box_bytes(B) + (stream ? (size_t)8 * NC1 * 128 : 0);
}
__host__ __device__ inline size_t dt_fixed_bytes(int Te, int P, int heads, int H1, int H2,
                                                 int NC1, int NC2, bool stream) {
  return TC_ALIGN + dt_w_bytes(H1, H2, P, NC1, NC2, stream) + dt_red_bytes(NC1, NC2) +
         dt_att_bytes(Te, P, heads) + DT_BAR_BYTES;
}
__host__ __device__ inline int dt_stages(int B, int Te, int P, int heads, int H1, int H2, int NC1,
                                         int NC2, bool stream) {
  const size_t fixed = dt_fixed_bytes(Te, P, heads, H1, H2, NC1, NC2, stream);
  const int room = fixed < (size_t)TC_SMEM_LIMIT
                       ? (int)((TC_SMEM_LIMIT - fixed) / dt_stage_bytes(B, NC1, stream))
                       : 0;
  return room < DT_MAX_STAGES ? room : DT_MAX_STAGES;
}
__host__ __device__ inline size_t dt_smem_bytes(int B, int Te, int P, int heads, int H1, int H2,
                                                int NC1, int NC2, bool stream) {
  return dt_fixed_bytes(Te, P, heads, H1, H2, NC1, NC2, stream) +
         (size_t)dt_stages(B, Te, P, heads, H1, H2, NC1, NC2, stream) *
             dt_stage_bytes(B, NC1, stream);
}

// Attention, classifier and feedback of batch row r at step t (the per-row
// design of speller_decode.cu's attend_phase, on the consumers' named
// barrier): writes the context into its exchange slot, the weights, logits
// and id, and the next step's fed id as a one-hot row (and, TRAIN, into the
// fed-id stream).
template <bool TRAIN>
__device__ __forceinline__ void attend_row(const DecodeTcArgs& a, int t, int r,
                                           __nv_bfloat16* ctx_out, float* q_s, float* ctx_s,
                                           float* part_s, float* red_s, float* sc_s) {
  using T = __nv_bfloat16;
  constexpr int VEC = 8;
  const int P = a.P, Te = a.Te, heads = a.heads, Vp = a.Vp, ldb = a.ldb;
  const int d = P / heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* kmat = static_cast<const T*>(a.p[T_K]);
  const T* vmat = static_cast<const T*>(a.p[T_V]);
  const T* bias = static_cast<const T*>(a.p[T_BIAS]);
  const T* wcls = static_cast<const T*>(a.p[T_WCLS]);
  const T* clsb = static_cast<const T*>(a.p[T_CLSB]);
  const T* qx = static_cast<const T*>(a.p[T_QX]);
  const int* forced = static_cast<const int*>(a.p[T_FORCED]);
  T* logits = static_cast<T*>(const_cast<void*>(a.p[T_LOGITS]));
  T* wgts = static_cast<T*>(const_cast<void*>(a.p[T_WGTS]));
  int* ids = static_cast<int*>(const_cast<void*>(a.p[T_IDS]));
  T* selx = static_cast<T*>(const_cast<void*>(a.p[T_SELX]));
  int* sel = static_cast<int*>(const_cast<void*>(a.p[T_SEL]));

  // q (already rounded to bf16 by the query phase)
  for (int p = threadIdx.x; p < P; p += NTHREADS) q_s[p] = ld_cg(qx + (long long)r * P + p);
  named_barrier(1, DT_CONSUMERS);
  DT_STAMP(S_Q_LOADED, t);

  // scores[h][te] = (sum_i q[h, i] * k[te, h, i]) * scale + bias[te]
  const T* krow = kmat + (long long)r * Te * P;
  for (int item = threadIdx.x; item < heads * Te; item += NTHREADS) {
    const int h = item / Te, te = item % Te;
    const T* kp = krow + (long long)te * P + h * d;
    const float* qp = q_s + h * d;
    float s = 0.0f;
#pragma unroll 8
    for (int i = 0; i < d; i += VEC) {
      float kv[VEC];
      load16_nc(kp + i, kv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += __fmul_rn(qp[i + j], kv[j]);
    }
    sc_s[item] = __fadd_rn(__fmul_rn(s, a.scale), ld_nc(bias + (long long)r * Te + te));
  }
  named_barrier(1, DT_CONSUMERS);
  DT_STAMP(S_SCORES, t);

  // softmax per head, weights out in bf16: wph = NWARPS / heads warps a
  // head where heads divides NWARPS (frames split between them, their maxima
  // and sums meeting in part_s), else warp h
  T* wrow = wgts + ((long long)t * ldb + r) * heads * Te;
  const int wph = NWARPS % heads == 0 ? NWARPS / heads : 1;
  if (wph > 1) {
    const int h = warp / wph, k = warp % wph;
    float* sh = sc_s + h * Te;
    float mx = -CUDART_INF_F;
    for (int te = k * 32 + lane; te < Te; te += wph * 32) mx = fmaxf(mx, sh[te]);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    if (lane == 0) part_s[warp] = mx;
    named_barrier(1, DT_CONSUMERS);
    mx = part_s[h * wph];
    for (int i = 1; i < wph; ++i) mx = fmaxf(mx, part_s[h * wph + i]);
    float sum = 0.0f;
    for (int te = k * 32 + lane; te < Te; te += wph * 32) {
      const float e = expf(sh[te] - mx);
      sh[te] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (lane == 0) part_s[NWARPS + warp] = sum;
    named_barrier(1, DT_CONSUMERS);
    sum = part_s[NWARPS + h * wph];
    for (int i = 1; i < wph; ++i) sum += part_s[NWARPS + h * wph + i];
    for (int te = k * 32 + lane; te < Te; te += wph * 32) {
      const float w = sh[te] / sum;
      sh[te] = w;
      wrow[h * Te + te] = from_f<T>(w);
    }
  } else {
    for (int h = warp; h < heads; h += NWARPS) {
      float* sh = sc_s + h * Te;
      float mx = -CUDART_INF_F;
      for (int te = lane; te < Te; te += 32) mx = fmaxf(mx, sh[te]);
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      float sum = 0.0f;
      for (int te = lane; te < Te; te += 32) {
        const float e = expf(sh[te] - mx);
        sh[te] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      for (int te = lane; te < Te; te += 32) {
        const float w = sh[te] / sum;
        sh[te] = w;
        wrow[h * Te + te] = from_f<T>(w);
      }
    }
  }
  named_barrier(1, DT_CONSUMERS);
  DT_STAMP(S_SOFTMAX, t);

  // context[p] = sum_te w[h(p)][te] * v[te, p], w rounded to bf16: thread
  // (group g, slice s) sums frames g, g + groups, ... of the VEC columns of
  // slice s in order, with 16-byte loads, U frames' loads in flight; the
  // groups' sums meet in shared memory
  const T* vrow = vmat + (long long)r * Te * P;
  const int slices = P / VEC, groups = NTHREADS / slices;
  const int g = threadIdx.x / slices, p0 = (threadIdx.x % slices) * VEC;
  if (g < groups) {
    const float* wh = sc_s + (p0 / d) * Te;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    constexpr int U = 8;  // frames in flight a thread
    for (int te0 = g; te0 < Te; te0 += U * groups) {
      float vv[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int te = te0 + u * groups;
        if (te < Te) load16_nc(vrow + (long long)te * P + p0, vv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int te = te0 + u * groups;
        if (te < Te) {
          const float w = round_to<T>(wh[te]);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += __fmul_rn(w, vv[u][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) red_s[g * P + p0 + j] = acc[j];
  }
  named_barrier(1, DT_CONSUMERS);
  for (int p = threadIdx.x; p < P; p += NTHREADS) {
    float acc = 0.0f;
    for (int k = 0; k < groups; ++k) acc += red_s[k * P + p];
    ctx_s[p] = round_to<T>(acc);
    ctx_out[(long long)r * P + p] = from_f<T>(acc);
  }
  named_barrier(1, DT_CONSUMERS);
  DT_STAMP(S_CONTEXT, t);

  // tied classifier over cat(q, ctx): warp w sums its slice of the 2P
  // inputs for vocabulary entry `lane` in order (the loop unrolled, so that
  // the loads of wcls go out together ahead of the chain)
  {
    const int span = 2 * P / NWARPS;
    float part = 0.0f;
    if (lane < Vp)
#pragma unroll 16
      for (int e = warp * span; e < (warp + 1) * span; ++e) {
        const float x = e < P ? q_s[e] : ctx_s[e - P];
        part = fmaf(x, ld_nc(wcls + (long long)e * Vp + lane), part);
      }
    part_s[warp * 32 + lane] = part;
  }
  named_barrier(1, DT_CONSUMERS);
  DT_STAMP(S_CLASSIFIER, t);
  if (warp == 0) {
    float logit = -CUDART_INF_F;
    if (lane < Vp) {
      float s = 0.0f;
      for (int w = 0; w < NWARPS; ++w) s += part_s[w * 32 + lane];
      logit = s + ld_nc(clsb + lane);
      logits[((long long)t * ldb + r) * Vp + lane] = from_f<T>(logit);
    }
    // first maximum of the fp32 logits (ties to the lowest index)
    float best = logit;
    int idx = lane;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, o);
      const int oi = __shfl_xor_sync(FULL, idx, o);
      if (ob > best || (ob == best && oi < idx)) {
        best = ob;
        idx = oi;
      }
    }
    if (lane == 0) ids[(long long)t * ldb + r] = idx;
    if (t + 1 < a.T) {  // the next step's fed id: forced where >= 0, else this argmax
      int next = forced != nullptr ? forced[(long long)(t + 1) * ldb + r] : -1;
      if (next < 0) next = idx;
      if constexpr (TRAIN) {
        if (lane == 0) sel[(long long)(t + 1) * ldb + r] = next;
      }
      const float pair[2] = {2 * lane == next ? 1.0f : 0.0f, 2 * lane + 1 == next ? 1.0f : 0.0f};
      store_bf16<2>(selx + ((long long)((t + 1) & 1) * ldb + r) * DT_SEL + 2 * lane, pair);
    }
  }
  named_barrier(1, DT_CONSUMERS);  // the row's shared buffers are reused by the next row
}

template <bool TRAIN, int NC1, int NC2, bool STREAM>
__global__ void __launch_bounds__(DT_THREADS, 1)
    speller_decode_tc_kernel(DecodeTcArgs a, const __grid_constant__ CUtensorMap map_h1,
                             const __grid_constant__ CUtensorMap map_h2,
                             const __grid_constant__ CUtensorMap map_ctx,
                             const __grid_constant__ CUtensorMap map_sel,
                             const __grid_constant__ CUtensorMap map_w1, unsigned* ctr) {
  using T = __nv_bfloat16;
  constexpr int N1 = 8 * NC1, N2 = 8 * NC2;
  constexpr int R1 = NC1, R2 = NC2;  // unit slots of one row a thread owns
  extern __shared__ __align__(TC_ALIGN) unsigned char smem_raw[];

  const int B = a.B, ldb = a.ldb, P = a.P, H1 = a.H1, H2 = a.H2, nsteps = a.T;
  const int G = gridDim.x;
  const int U1 = H1 / G, U2 = H2 / G;  // units of each cell a block owns
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u01 = blockIdx.x * U1, u02 = blockIdx.x * U2;
  const int nqb = P / DT_QCOLS;
  const bool qblock = blockIdx.x < nqb;
  const int q0 = blockIdx.x * DT_QCOLS;
  const int ch1 = H1 / DT_KC, ch2 = H2 / DT_KC, chc = P / DT_KC;
  const int K1 = H1 + P + DT_SEL, K2 = H2 + H1;
  const int S = dt_stages(B, a.Te, P, a.heads, H1, H2, NC1, NC2, STREAM);
  const int box_bytes = (int)dt_box_bytes(B);  // a stage's input box; its weight rows follow
  const int stage_bytes = (int)dt_stage_bytes(B, NC1, STREAM);

  unsigned char* w1_s =  // the resident cell-1 tile (none in the streamed form)
      smem_raw + ((TC_ALIGN - (smem_u32(smem_raw) & (TC_ALIGN - 1))) & (TC_ALIGN - 1));
  unsigned char* w2_s = w1_s + (STREAM ? 0 : dt_w1_bytes(H1, P, NC1));
  unsigned char* wq_s = w2_s + (size_t)(K2 / DT_KC) * N2 * 128;
  unsigned char* ring = w1_s + dt_w_bytes(H1, H2, P, NC1, NC2, STREAM);
  float* red_s = reinterpret_cast<float*>(ring + (size_t)S * stage_bytes);
  float* q_s = red_s + dt_red_bytes(NC1, NC2) / sizeof(float);
  float* ctx_s = q_s + P;
  float* part_s = ctx_s + P;
  float* cred_s = part_s + NWARPS * DT_VMAX;
  float* sc_s = cred_s + NTHREADS * 8;
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(q_s) +
                                               dt_att_bytes(a.Te, P, a.heads));
  const uint32_t ring_addr = smem_u32(ring);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + DT_MAX_STAGES);

  // this block's weight columns, K-major, one 64-k tile after another: cell
  // 1 over [h1; ctx; one-hot] against [whh1; wc1; embw1 (zero past Vp)],
  // cell 2 over [h2; h1] against [whh2; wih2], the query over h2 against wq;
  // the columns of a unit slot past U are zeros
  {
    const T* whh1 = static_cast<const T*>(a.p[T_WHH1]);
    const T* wc1 = static_cast<const T*>(a.p[T_WC1]);
    const T* embw1 = static_cast<const T*>(a.p[T_EMBW1]);
    const T* whh2 = static_cast<const T*>(a.p[T_WHH2]);
    const T* wih2 = static_cast<const T*>(a.p[T_WIH2]);
    const T* wq = static_cast<const T*>(a.p[T_WQ]);
    auto put = [](unsigned char* tile, int N, int n, int k, T v) {
      const int kk = k % DT_KC;
      *reinterpret_cast<T*>(tile + (size_t)(k / DT_KC) * N * 128 + swz(n, kk >> 3) +
                            (kk & 7) * 2) = v;
    };
    const T zero = __float2bfloat16(0.0f);
    for (int idx = tid; idx < (STREAM ? 0 : K1 * N1); idx += DT_THREADS) {
      const int n = idx % N1, k = idx / N1;
      const long long col = (long long)(n & 3) * H1 + u01 + (n >> 2);
      T v;
      if ((n >> 2) >= U1)
        v = zero;
      else if (k < H1)
        v = whh1[(long long)k * 4 * H1 + col];
      else if (k < H1 + P)
        v = wc1[(long long)(k - H1) * 4 * H1 + col];
      else
        v = k - H1 - P < a.Vp ? embw1[(long long)(k - H1 - P) * 4 * H1 + col] : zero;
      put(w1_s, N1, n, k, v);
    }
    for (int idx = tid; idx < K2 * N2; idx += DT_THREADS) {
      const int n = idx % N2, k = idx / N2;
      const long long col = (long long)(n & 3) * H2 + u02 + (n >> 2);
      put(w2_s, N2, n, k,
          (n >> 2) >= U2 ? zero
          : k < H2       ? whh2[(long long)k * 4 * H2 + col]
                         : wih2[(long long)(k - H2) * 4 * H2 + col]);
    }
    if (qblock)
      for (int idx = tid; idx < H2 * DT_QCOLS; idx += DT_THREADS) {
        const int n = idx % DT_QCOLS, k = idx / DT_QCOLS;
        put(wq_s, DT_QCOLS, n, k, wq[(long long)k * P + q0 + n]);
      }
  }
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, DT_CONSUMERS / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  fence_proxy_async();  // the resident weights, written by st.shared, are read by wgmma
  __syncthreads();

  // the exchange slot of value s = step - 1 (read at step t) and of step t
  auto slot_prev = [&](int t) { return TRAIN ? t : (t & 1); };
  auto slot_next = [&](int t) { return TRAIN ? t + 1 : ((t + 1) & 1); };

  // ---- the producer: lane 0 of the last warp fills the ring, in the order
  // the consumers take the chunks (in the streamed form cell 1's with the
  // block's weight rows of the same 64 k behind the input box)
  if (warp == DT_CONSUMERS / 32) {
    if (lane == 0) {
      int slot = 0;
      unsigned phase = 0;
      auto fill = [&](const CUtensorMap* map, int col, int slab, int wk = -1) {
        mbar_wait(empty0 + 8 * slot, phase ^ 1);
        const uint32_t full = full0 + 8 * slot, dst = ring_addr + slot * stage_bytes;
        const bool with_w = STREAM && wk >= 0;
        mbar_arrive_expect_tx(full, box_bytes + (with_w ? N1 * 128 : 0));
        tma_load_3d(dst, map, full, col, 0, slab);
        if (with_w) tma_load_3d(dst + box_bytes, &map_w1, full, wk, blockIdx.x * N1, 0);
        if (++slot == S) slot = 0, phase ^= 1;
      };
      auto await = [&](int c, unsigned target) {
        while (load_acquire(ctr + c) < target) {
        }
        fence_proxy_async_global();  // the acquire, then the TMA reads of what it published
      };
      for (int t = 0; t < nsteps; ++t) {
        const int sp = slot_prev(t), sn = slot_next(t);
        const unsigned done_prev = (unsigned)(t + 1) * G, done_now = (unsigned)(t + 2) * G;
        await(C_CELL1, done_prev);  // cell 1 (t): h1_{t-1}, then ctx_{t-1} and the one-hot
        for (int c = 0; c < ch1; ++c) fill(&map_h1, c * DT_KC, sp, c * DT_KC);
        await(C_ATTEND, done_prev);
        DT_STAMP(S_PRODUCER_ATTEND, t);
        for (int c = 0; c < chc; ++c) fill(&map_ctx, c * DT_KC, sp, H1 + c * DT_KC);
        fill(&map_sel, 0, t & 1, H1 + P);
        await(C_CELL2, done_prev);  // cell 2 (t): h2_{t-1}, then h1_t
        for (int c = 0; c < ch2; ++c) fill(&map_h2, c * DT_KC, sp);
        await(C_CELL1, done_now);
        DT_STAMP(S_PRODUCER_CELL1, t);
        for (int c = 0; c < ch1; ++c) fill(&map_h1, c * DT_KC, sn);
        if (qblock) {  // the query (t): h2_t
          await(C_CELL2, done_now);
          for (int c = 0; c < ch2; ++c) fill(&map_h2, c * DT_KC, sn);
        }
      }
    }
    return;
  }

  // ---- the consumers
  const int wg = warp / 4;
  const bool split = B <= 64;     // both warpgroups on rows 0..63, the k-chunks split
  const int rg = split ? 0 : wg;  // the 64 rows of the warpgroup's products
  // a thread's cells: unit slots [ub, ub + R) of row `row`, the first n of
  // them units of the block (all where U = 2 R, and then one access each)
  const int row = tid >> 1, half = tid & 1;
  const bool live = row < B;
  const int ub1 = half * R1, ub2 = half * R2;
  const int n1 = min(max(U1 - ub1, 0), R1), n2 = min(max(U2 - ub2, 0), R2);
  const bool vec1 = U1 == 2 * R1, vec2 = U2 == 2 * R2;
  T* h1x = static_cast<T*>(const_cast<void*>(a.p[T_H1X]));
  T* h2x = static_cast<T*>(const_cast<void*>(a.p[T_H2X]));
  T* ctxx = static_cast<T*>(const_cast<void*>(a.p[T_CTXX]));
  T* selx = static_cast<T*>(const_cast<void*>(a.p[T_SELX]));
  T* qx = static_cast<T*>(const_cast<void*>(a.p[T_QX]));
  const int* forced = static_cast<const int*>(a.p[T_FORCED]);
  const T* m1 = static_cast<const T*>(a.p[T_M1]);
  const T* m2 = static_cast<const T*>(a.p[T_M2]);
  int* sel = static_cast<int*>(const_cast<void*>(a.p[T_SEL]));
  T* gates1 = static_cast<T*>(const_cast<void*>(a.p[T_GATES1]));
  T* c1r = static_cast<T*>(const_cast<void*>(a.p[T_C1R]));
  T* gates2 = static_cast<T*>(const_cast<void*>(a.p[T_GATES2]));
  T* c2r = static_cast<T*>(const_cast<void*>(a.p[T_C2R]));
  const long long xsc = (long long)ldb * P;  // a slot of the context exchange

  // the t = -1 state: the thread's c carries into registers, its h columns
  // and its rows' context and first fed id into the exchanges' first slot
  float c1[R1], c2[R2], b2v[R2][4], bqv[4];
  {
    const T* b2 = static_cast<const T*>(a.p[T_B2]);
    const T* bq = static_cast<const T*>(a.p[T_BQ]);
#pragma unroll
    for (int i = 0; i < R2; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) b2v[i][g] = i < n2 ? to_f(b2[g * H2 + u02 + ub2 + i]) : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) bqv[j] = qblock ? to_f(bq[q0 + 4 * half + j]) : 0.0f;
    float v1[R1], v2[R2];
#pragma unroll
    for (int i = 0; i < R1; ++i) c1[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < R2; ++i) c2[i] = 0.0f;
    if (live) {
      const long long o1 = (long long)row * H1 + u01 + ub1, o2 = (long long)row * H2 + u02 + ub2;
      load_units<R1>(static_cast<const T*>(a.p[T_C10]) + o1, n1, vec1, c1);
      load_units<R2>(static_cast<const T*>(a.p[T_C20]) + o2, n2, vec2, c2);
      load_units<R1>(static_cast<const T*>(a.p[T_H10]) + o1, n1, vec1, v1);
      load_units<R2>(static_cast<const T*>(a.p[T_H20]) + o2, n2, vec2, v2);
      store_units<R1>(h1x + o1, n1, vec1, v1);  // slot 0
      store_units<R2>(h2x + o2, n2, vec2, v2);
    }
    const T* ctx0 = static_cast<const T*>(a.p[T_CTX0]);
    for (int r = blockIdx.x; r < B; r += G) {
      for (int p = tid; p < P; p += DT_CONSUMERS) ctxx[(long long)r * P + p] = ctx0[(long long)r * P + p];
      if (warp == 0) {
        int first = forced != nullptr ? forced[r] : -1;
        if (first < 0) first = a.sos;
        if constexpr (TRAIN) {
          if (lane == 0) sel[r] = first;
        }
        const float pair[2] = {2 * lane == first ? 1.0f : 0.0f, 2 * lane + 1 == first ? 1.0f : 0.0f};
        store_bf16<2>(selx + (long long)r * DT_SEL + 2 * lane, pair);
      }
    }
    fence_proxy_async_global();  // read by other blocks' TMA
    named_barrier(1, DT_CONSUMERS);
    if (tid == 0) {
      arrive_release(ctr + C_CELL1);
      arrive_release(ctr + C_CELL2);
      arrive_release(ctr + C_ATTEND);
    }
  }

  int slot = 0;
  unsigned phase = 0;
  constexpr uint32_t IN_RING = 0xffffffffu;  // no shared address
  // one product: the next `nk` chunks of the ring against the weight tile at
  // w_addr (N columns; IN_RING: the weight rows behind each stage's input
  // box), the warpgroups' sums into the gate tile: warpgroup wg's rows at
  // tile rows 64 wg + (0..63) (its own rows past 64 rows of batch, the same
  // rows 0..63 as the other warpgroup's up to 64)
  auto product = [&](auto ncols, int nk, uint32_t w_addr) {
    constexpr int N = decltype(ncols)::value;
    constexpr int RS = N + 8;
    float acc[N / 2];
#pragma unroll
    for (int q = 0; q < N / 2; ++q) acc[q] = 0.0f;
    int pend = -1;  // the slot of this warpgroup's product group in flight
    for (int c = 0; c < nk; ++c) {
      mbar_wait(full0 + 8 * slot, phase);
      if (!split || (c & 1) == wg) {
        const uint32_t a_t = ring_addr + slot * stage_bytes + rg * 64 * 128;
        const uint32_t b_t =
            w_addr != IN_RING ? w_addr + c * N * 128 : ring_addr + slot * stage_bytes + box_bytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16<N>(acc, sw128_desc(a_t + kk * 32), sw128_desc(b_t + kk * 32));
        wgmma_commit();
        if (pend >= 0) {  // the previous group is done: release its stage
          wgmma_wait<1>(acc);
          if (lane == 0) mbar_arrive(empty0 + 8 * pend);
        }
        pend = slot;
      } else if (lane == 0) {
        mbar_arrive(empty0 + 8 * slot);  // not read by this warpgroup
      }
      if (++slot == S) slot = 0, phase ^= 1;
    }
    wgmma_wait<0>(acc);
    if (pend >= 0 && lane == 0) mbar_arrive(empty0 + 8 * pend);
    const int r = wg * 64 + (warp % 4) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(red_s + r * RS + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(red_s + (r + 8) * RS + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_barrier(1, DT_CONSUMERS);
  };
  // the gate sums of column n of the thread's row, in the fixed order
  auto gate_sums = [&](auto ncols, int n, float* pre) {
    constexpr int RS = decltype(ncols)::value + 8;
    const float4 p = *reinterpret_cast<const float4*>(red_s + row * RS + n);
    pre[0] = p.x, pre[1] = p.y, pre[2] = p.z, pre[3] = p.w;
    if (split) {
      const float4 o = *reinterpret_cast<const float4*>(red_s + (64 + row) * RS + n);
      pre[0] += o.x, pre[1] += o.y, pre[2] += o.z, pre[3] += o.w;
    }
  };
  // the LSTM cell of R units from their gate sums: the fp32 carry, the
  // output times the mask in fp32, the gates kept for the stores
  auto cell = [](const float* pre, float& c, float keep, float* gv, float& cv, float& hv) {
    const float ig = sigmoidf(pre[0]);
    const float fg = sigmoidf(pre[1]);
    const float gg = tanhf(pre[2]);
    const float og = sigmoidf(pre[3]);
    c = fg * c + ig * gg;
    gv[0] = ig, gv[1] = fg, gv[2] = gg, gv[3] = og;
    cv = c;
    hv = og * tanhf(c) * keep;
  };
  // the end of a phase: the block's stores are published through counter c
  auto publish = [&](int c) {
    fence_proxy_async_global();  // stores read by other blocks' TMA
    named_barrier(1, DT_CONSUMERS);
    if (tid == 0) arrive_release(ctr + c);
  };
  const uint32_t w1_addr = STREAM ? IN_RING : smem_u32(w1_s), w2_addr = smem_u32(w2_s),
                 wq_addr = smem_u32(wq_s);

  for (int t = 0; t < nsteps; ++t) {
    const int sn = slot_next(t);
    // the step's masks, ahead of the products
    float keep1[R1], keep2[R2];
#pragma unroll
    for (int i = 0; i < R1; ++i) keep1[i] = 1.0f;
#pragma unroll
    for (int i = 0; i < R2; ++i) keep2[i] = 1.0f;
    if constexpr (TRAIN) {
      if (live && m1 != nullptr) {
        load_units<R1>(m1 + ((long long)t * ldb + row) * H1 + u01 + ub1, n1, vec1, keep1);
        load_units<R2>(m2 + ((long long)t * ldb + row) * H2 + u02 + ub2, n2, vec2, keep2);
      }
    }

    // cell 1
    DT_STAMP(S_STEP, t);
    product(Cols<N1>{}, ch1 + chc + 1, w1_addr);
    DT_STAMP(S_CELL1_PRODUCT, t);
    float gv1[4][R1], cv1[R1];
    if (live) {
      float hv[R1];
#pragma unroll
      for (int i = 0; i < R1; ++i) {
        float pre[4], gi[4];
        gate_sums(Cols<N1>{}, 4 * (ub1 + i), pre);
        cell(pre, c1[i], keep1[i], gi, cv1[i], hv[i]);
#pragma unroll
        for (int g = 0; g < 4; ++g) gv1[g][i] = gi[g];
      }
      const long long o = ((long long)sn * ldb + row) * H1 + u01 + ub1;
      store_units<R1>(h1x + o, n1, vec1, hv);
    }
    publish(C_CELL1);
    DT_STAMP(S_CELL1_PUBLISHED, t);
    if constexpr (TRAIN) {  // the residual streams, read by no block: after the publish
      if (live) {
        const long long ot = ((long long)t * ldb + row) * H1 + u01 + ub1;
        store_units<R1>(c1r + ot, n1, vec1, cv1);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          store_units<R1>(gates1 + ((long long)t * ldb + row) * 4 * H1 + g * H1 + u01 + ub1, n1,
                          vec1, gv1[g]);
      }
    }

    // cell 2
    product(Cols<N2>{}, ch2 + ch1, w2_addr);
    DT_STAMP(S_CELL2_PRODUCT, t);
    float gv2[4][R2], cv2[R2];
    if (live) {
      float hv[R2];
#pragma unroll
      for (int i = 0; i < R2; ++i) {
        float pre[4], gi[4];
        gate_sums(Cols<N2>{}, 4 * (ub2 + i), pre);
#pragma unroll
        for (int g = 0; g < 4; ++g) pre[g] += b2v[i][g];
        cell(pre, c2[i], keep2[i], gi, cv2[i], hv[i]);
#pragma unroll
        for (int g = 0; g < 4; ++g) gv2[g][i] = gi[g];
      }
      const long long o = ((long long)sn * ldb + row) * H2 + u02 + ub2;
      store_units<R2>(h2x + o, n2, vec2, hv);
    }
    publish(C_CELL2);
    DT_STAMP(S_CELL2_PUBLISHED, t);
    if constexpr (TRAIN) {
      if (live) {
        const long long ot = ((long long)t * ldb + row) * H2 + u02 + ub2;
        store_units<R2>(c2r + ot, n2, vec2, cv2);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          store_units<R2>(gates2 + ((long long)t * ldb + row) * 4 * H2 + g * H2 + u02 + ub2, n2,
                          vec2, gv2[g]);
      }
    }

    // the query: q = h2 . wq + bq, rounded to bf16
    if (qblock) {
      product(Cols<DT_QCOLS>{}, ch2, wq_addr);
      if (live) {
        constexpr int RS = DT_QCOLS + 8;
        float qv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = red_s[row * RS + 4 * half + j];
          if (split) qv[j] += red_s[(64 + row) * RS + 4 * half + j];
          qv[j] += bqv[j];
        }
        store_bf16<4>(qx + (long long)row * P + q0 + 4 * half, qv);
      }
      publish(C_QUERY);
    }
    DT_STAMP(S_QUERY_PUBLISHED, t);

    // attention, classifier and feedback of the block's rows
    if (tid == 0) {
      const unsigned target = (unsigned)(t + 1) * nqb;
      while (load_acquire(ctr + C_QUERY) < target) {
      }
    }
    named_barrier(1, DT_CONSUMERS);
    DT_STAMP(S_QUERY_ACQUIRED, t);
    for (int r = blockIdx.x; r < B; r += G)
      attend_row<TRAIN>(a, t, r, ctxx + sn * xsc, q_s, ctx_s, part_s, cred_s, sc_s);
    publish(C_ATTEND);
    DT_STAMP(S_ATTEND_PUBLISHED, t);
  }
}

// the map of an exchange (slots, ldb, X) bf16 from the launch's first row:
// boxes of 64 columns x the launch's rows rounded up to 64 x one slot, the
// 128-byte swizzle; rows past the launch's read as zeros
static bool encode_exchange(EncodeTiledFn encode, CUtensorMap* map, const void* base, int X,
                            int B, int ldb, int slots) {
  const cuuint64_t dims[3] = {(cuuint64_t)X, (cuuint64_t)B, (cuuint64_t)slots};
  const cuuint64_t strides[2] = {(cuuint64_t)X * 2, (cuuint64_t)X * 2 * ldb};
  const cuuint32_t box[3] = {DT_KC, (cuuint32_t)dt_box_rows(B), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the map of the streamed form's cell-1 weights (G N1, K1) bf16: boxes of 64
// k x the block's N1 rows, the 128-byte swizzle (the resident tile's layout)
static bool encode_weights(EncodeTiledFn encode, CUtensorMap* map, const void* base, int K1,
                           int rows, int N1) {
  const cuuint64_t dims[3] = {(cuuint64_t)K1, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)K1 * 2, (cuuint64_t)K1 * 2 * rows};
  const cuuint32_t box[3] = {DT_KC, (cuuint32_t)N1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TRAIN, int NC1, int NC2, bool STREAM>
static cudaError_t dt_launch(const DecodeTcArgs& a, int G, const CUtensorMap* maps,
                             unsigned* ctr, cudaStream_t stream) {
  auto kernel = speller_decode_tc_kernel<TRAIN, NC1, NC2, STREAM>;
  const size_t smem = dt_smem_bytes(a.B, a.Te, a.P, a.heads, a.H1, a.H2, NC1, NC2, STREAM);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  DecodeTcArgs args = a;
  CUtensorMap m0 = maps[0], m1 = maps[1], m2 = maps[2], m3 = maps[3], m4 = maps[4];
  void* params[] = {&args, &m0, &m1, &m2, &m3, &m4, &ctr};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(G), dim3(DT_THREADS),
                                    params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The geometry the wrapper (ops/speller_cuda.py::plan_decode_tc) mirrors,
// and the shared memory a block of `device` may opt into: out = {DT_ROWS,
// DT_MAX_GRID, DT_MAX_UNITS1, DT_MAX_UNITS2, DT_KC, DT_SEL, DT_QCOLS,
// DT_VMAX, DT_MAX_STAGES, DT_MIN_STAGES, TC_SMEM_LIMIT, DT_THREADS, opt-in
// bytes, SMs}. Returns a cudaError_t (0 on success).
extern "C" int speller_decode_tc_limits(int device, long long* out) {
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long v[] = {DT_ROWS,   DT_MAX_GRID,   DT_MAX_UNITS1, DT_MAX_UNITS2, DT_KC,
                         DT_SEL,    DT_QCOLS,      DT_VMAX,       DT_MAX_STAGES, DT_MIN_STAGES,
                         TC_SMEM_LIMIT, DT_THREADS, optin,        sms};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return (int)err;
}

// N / 8 of a product of U units a block (four gate columns a unit)
__host__ __device__ inline int dt_nc(int U) { return (U + 1) / 2; }

// bytes of dynamic shared memory of a launch of B rows on G blocks, of the
// resident (streamed 0) or the streamed form
extern "C" size_t speller_decode_tc_smem_bytes(int B, int Te, int P, int heads, int H1, int H2,
                                               int G, int streamed) {
  return dt_smem_bytes(B, Te, P, heads, H1, H2, dt_nc(H1 / G), dt_nc(H2 / G), streamed != 0);
}

// One launch of B <= DT_ROWS rows on dims[E_G] blocks, of the resident
// (streamed 0) or the streamed form. ptrs: N_TC_PTRS device pointers in enum
// TcPtr order, each at the launch's first row (P_FORCED may be null; with
// train == 0 the slots from T_M1 to T_C2R are not read; with train != 0 T_M1
// and T_M2 may be null; T_W1S only in the streamed form, where only the
// (NC1, NC2) pairs of DT_SCASE are built: (4, 1) and (4, 2), the
// blocks whose resident tiles do not fit); the exchanges T_H1X, T_H2X, T_CTXX hold `slots` slots
// (2, or T + 1 in the training form, whose slot 0 is the t = -1 state and
// the others the residual streams), T_SELX 2, each of ldb rows. dims:
// N_TC_DIMS ints in enum TcDim order. ctr: N_CTRS zeroed counters. The
// wrapper checks the shapes first (plan_decode_tc); what this refuses
// returns cudaErrorInvalidValue. Returns a cudaError_t (0 on success).
extern "C" int speller_decode_tc_launch(int train, int streamed, const void* const* ptrs,
                                        const int* dims, int slots, float scale, void* ctr,
                                        void* stream) {
  DecodeTcArgs a;
  for (int i = 0; i < N_TC_PTRS; ++i) a.p[i] = ptrs[i];
  a.B = dims[E_B];
  a.ldb = dims[E_LDB];
  a.Te = dims[E_TE];
  a.T = dims[E_T];
  a.P = dims[E_P];
  a.heads = dims[E_HEADS];
  a.H1 = dims[E_H1];
  a.H2 = dims[E_H2];
  a.Vp = dims[E_VP];
  a.sos = dims[E_SOS];
  a.scale = scale;
  const int G = dims[E_G];
  const int U1 = G > 0 && a.H1 % G == 0 ? a.H1 / G : 0;
  const int U2 = G > 0 && a.H2 % G == 0 ? a.H2 / G : 0;
  const int nc1 = dt_nc(U1), nc2 = dt_nc(U2);
  const bool shape_ok =
      a.B >= 1 && a.B <= DT_ROWS && a.ldb >= a.B && a.T >= 1 && a.Te >= 1 && a.H2 % DT_KC == 0 &&
      a.H1 % DT_KC == 0 && a.P % DT_KC == 0 && G >= 1 && G <= DT_MAX_GRID && U1 >= 1 &&
      U1 <= DT_MAX_UNITS1 && U2 >= 1 && U2 <= DT_MAX_UNITS2 && a.P / DT_QCOLS <= G &&
      a.heads >= 1 && a.P % a.heads == 0 && (a.P / a.heads) % 8 == 0 && a.Vp >= 1 &&
      a.Vp <= DT_VMAX &&
      dt_stages(a.B, a.Te, a.P, a.heads, a.H1, a.H2, nc1, nc2, streamed != 0) >= DT_MIN_STAGES &&
      (streamed == 0) == (a.p[T_W1S] == nullptr);
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap maps[5] = {};
  if (!encode_exchange(encode, &maps[0], a.p[T_H1X], a.H1, a.B, a.ldb, slots) ||
      !encode_exchange(encode, &maps[1], a.p[T_H2X], a.H2, a.B, a.ldb, slots) ||
      !encode_exchange(encode, &maps[2], a.p[T_CTXX], a.P, a.B, a.ldb, slots) ||
      !encode_exchange(encode, &maps[3], a.p[T_SELX], DT_SEL, a.B, a.ldb, 2) ||
      (streamed != 0 &&
       !encode_weights(encode, &maps[4], a.p[T_W1S], a.H1 + a.P + DT_SEL, G * 8 * nc1, 8 * nc1)))
    return (int)cudaErrorInvalidValue;
  unsigned* c = static_cast<unsigned*>(ctr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (streamed, form, NC1, NC2): every geometry of the limits above in the
  // resident form (DT_CASE); in the streamed form (DT_SCASE) the pairs of the
  // blocks it serves
#define DT_CASE(TR, A, B2) \
  case (TR) * 100 + (A) * 10 + (B2): return (int)dt_launch<TR, A, B2, false>(a, G, maps, c, s);
#define DT_SCASE(TR, A, B2)               \
  case 1000 + (TR) * 100 + (A) * 10 + (B2): \
    return (int)dt_launch<TR, A, B2, true>(a, G, maps, c, s);
#define DT_CASES(TR) \
  DT_CASE(TR, 1, 1) DT_CASE(TR, 1, 2) DT_CASE(TR, 2, 1) DT_CASE(TR, 2, 2) \
  DT_CASE(TR, 3, 1) DT_CASE(TR, 3, 2) DT_CASE(TR, 4, 1) DT_CASE(TR, 4, 2) \
  DT_SCASE(TR, 4, 1) DT_SCASE(TR, 4, 2)
  switch ((streamed ? 1000 : 0) + (train ? 100 : 0) + nc1 * 10 + nc2) {
    DT_CASES(false)
    DT_CASES(true)
  }
#undef DT_CASES
#undef DT_SCASE
#undef DT_CASE
  return (int)cudaErrorInvalidValue;
}
