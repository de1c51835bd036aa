// The bfloat16 adjoint of the fused speller decode for Hopper (sm_90a), with
// the batch rows of its three products on tensor cores (wgmma, bf16 operands
// from shared memory, fp32 accumulators) and their operands streamed by TMA:
// one cooperative launch walks every step of the decode backwards for up to
// 128 batch rows.
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/speller_pallas.py), in bf16:
//   _decode_bwd_kernel (:223) as _bwd_chunk (:554, the call at :578)
//   launches it: TPU kernel #9. float32 runs on speller_bwd.cu (CUDA-core
//   FMAs, the same steps).
//
// What it computes is speller_bwd.cu's (its header lists the phases and
// streams), with the numerics of the Pallas kernel and of
// ops/speller_cuda.py's plain version: the saved streams read in bf16;
// dpre, d_q, d_ctx and dsc * scale rounded to bf16 as dot operands and as
// stored; the attention products fp32 products of those rounded operands
// and K or V, summed in fp32; every other sum, the gate adjoints and the
// carries fp32. Time runs down; a step is four dependent phases:
//   (a) per row: d_ctx, dw, the softmax adjoint dsc, dq_att and d_q;
//   (b) d_h2d = dh2 + round(d_q) @ wq^T (K = P), cell 2's gate adjoint
//       -> dpre2[t];
//   (c) [d_h1d - dh1 | new dh2] = round(dpre2) @ [wih2; whh2]^T (K = 4 H2),
//       cell 1's gate adjoint -> dpre1[t];
//   (d) [new dh1 | new dctx] = round(dpre1) @ [whh1; wc1]^T (K = 4 H1).
//
// What bounds it on this card. The work is small (at base-LAS, B=128,
// ~0.8 GFLOP a step for the three products, about a microsecond of the
// tensor cores) and every phase needs the whole previous one, so a step
// costs the latency of four hand-offs between blocks, one row's attention
// adjoint (its K and V rows, 192 KB at base-LAS) and the bytes each block
// of a product phase reads from L2: phase (d) reads all of dpre1[t] (B x 4
// H1 bf16, 512 KB at base-LAS, 1 MB at scaled-LAS, B=128) in every block
// that owns (d) columns. The first float32 body walked the batch two rows a
// warp on the CUDA cores in each product phase and ended each phase with a
// grid barrier (~76 us a step at base-LAS, B=128; PERF.md).
//
// What the design does about it:
//   * Ownership by unit, not by phase. The outputs are one column a unit, so
//     the columns go 8 a "group" to the blocks: a cell-1 group (8 units of
//     cell 1) owns those units' columns in (c), where its epilogue applies
//     their gate adjoint, and in (d), where it forms their new dh1; a cell-2
//     group owns its units' columns in (b) (gate adjoint) and in (c) (new
//     dh2); a context group owns 8 columns of the new dctx in (d). The dh and
//     dc carries of a unit then never leave its block: a thread keeps those
//     of 4 units of one row in registers for the whole launch. The NG = (H1
//     + H2 + P) / 8 groups go round robin to the G = min(128, SMs) blocks,
//     group i to block i mod G (base-LAS: 64 + 32 + 32 = 128 groups, one a
//     block; scaled-LAS: 128 + 32 + 32, so 64 blocks own two). A block's N
//     in a phase is 8 x its groups active there (8 to 32).
//   * Products. Each product's input (dq[t], dpre2[t], dpre1[t]: the output
//     streams double as the exchanges) streams in 64-column TMA boxes of the
//     launch's rows, and the block's weight rows beside it in 8-row boxes of
//     the same 64 k, through one ring of shared-memory stages on full /
//     empty mbarriers: a producer warp, two consumer warpgroups (past 64 rows
//     each takes 64 rows over all k; up to 64 rows both take the same rows
//     and split the k-chunks), sums meeting in a shared-memory tile in the
//     fixed order warpgroup 0 + warpgroup 1. The weights stream each step
//     instead of staying in shared memory: a block's rows of [whh1; wc1]
//     alone are 32 KB a group at base-LAS and 64 KB at scaled-LAS, two
//     groups with the ring and the attention's buffers pass the card's 227
//     KB, and the weight boxes add ~6% to the bytes of the input stream each
//     (d) block reads anyway. So every shape the bf16 forward takes fits.
//   * Attention adjoint (per row): block r takes batch row
//     r (r += G): d_ctx from the fp32 dctx exchange, dw over V, the softmax
//     adjoint a warp a head, dq_att over K with 8 frames' loads in flight a
//     thread, d_q stored into the dq stream for (b).
//   * Synchronisation. No grid barrier: four monotonic counters, one a phase,
//     each block adding one (release) at the end of each phase of each step,
//     whether or not it owns columns there, waited for (acquire) by one
//     thread. Writes that other blocks read through TMA are fenced to the
//     async proxy before the release and after the acquire.
//   * Repeatability: a fixed sum order and no atomics on values, so two runs
//     are bit-equal.
//
// Who waits for what. Step s = 0, 1, ... is t = T - 1 - s; counter targets
// are in blocks ((s + 1) G: every block finished that phase of step s):
//   attend (s)  waits BACK >= s G (dctx from (d) of step s - 1; s > 0);
//   (b) (s)     its producer waits ATTEND >= (s + 1) G (dq[t] of every row);
//   (c) (s)     its producer waits CELL2 >= (s + 1) G (dpre2[t]);
//   (d) (s)     its producer waits CELL1 >= (s + 1) G (dpre1[t]).
// Every value of a stream is written once (slot t). Write-after-read: the
// dctx exchange, read by attend (s), is rewritten by (d) (s), whose input
// was loaded after CELL1 (s) of every block, so after every block's attend
// (s); the carries are registers. The dctx exchange is the output dctx0,
// which (d) at t = 0 leaves; the dh / dc carries are stored at the end.

#include "speller_common.cuh"
#include "wgmma_common.cuh"

constexpr int DB_CONSUMERS = NTHREADS;         // two warpgroups (the attention's threads)
constexpr int DB_THREADS = DB_CONSUMERS + 32;  // and the producer warp
constexpr int DB_ROWS = 128;                   // batch rows a launch
constexpr int DB_MAX_GRID = 128;               // blocks, at most: one per SM
constexpr int DB_KC = 64;                      // k of a ring stage: one TMA box
constexpr int DB_GCOLS = 8;                    // output columns of a group (wgmma's least N)
constexpr int DB_MAX_GROUPS = 4;               // groups a block, at most (N = 32)
constexpr int DB_MAX_STAGES = 8;
constexpr int DB_MIN_STAGES = 2;
constexpr int DB_BAR_BYTES = 2 * DB_MAX_STAGES * 8;
enum Ctr { C_ATTEND, C_CELL2, C_CELL1, C_BACK, N_CTRS };
enum Kind { G_CELL1, G_CELL2, G_CTX };

// Phase stamps for tools/trace_speller_decode.py. Built with -DDB_TRACE,
// thread 0 (and the producer's lane 0, its three) of blocks 0, G / 2 and
// G - 1 write %globaltimer at each phase boundary of the first
// DB_TRACE_STEPS steps, and thread 0 of every block when it publishes its
// attention adjoint (DB_STAMP_ATTEND); without it both are nothing and the
// kernel is the same.
enum Stamp {
  S_STEP, S_BACK_ACQUIRED, S_ATTEND_PUBLISHED, S_CELL2_PRODUCT, S_CELL2_PUBLISHED,
  S_CELL1_PRODUCT, S_CELL1_PUBLISHED, S_BACK_PRODUCT, S_BACK_PUBLISHED, S_PRODUCER_ATTEND,
  S_PRODUCER_CELL2, S_PRODUCER_CELL1, N_STAMPS
};
#ifdef DB_TRACE
constexpr int DB_TRACE_STEPS = 1024;
__device__ unsigned long long db_trace[3][N_STAMPS][DB_TRACE_STEPS];
__device__ unsigned long long db_trace_attend[DB_MAX_GRID][DB_TRACE_STEPS];
__device__ __forceinline__ void db_stamp(int e, int s) {
  const int b = blockIdx.x == 0 ? 0 : blockIdx.x == gridDim.x / 2 ? 1
                                    : blockIdx.x == gridDim.x - 1 ? 2 : -1;
  if (b < 0 || s >= DB_TRACE_STEPS || (threadIdx.x != 0 && threadIdx.x != DB_CONSUMERS)) return;
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  db_trace[b][e][s] = v;
}
__device__ __forceinline__ void db_stamp_attend(int s) {
  if (threadIdx.x != 0 || s >= DB_TRACE_STEPS) return;
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  db_trace_attend[blockIdx.x][s] = v;
}
// the stamps, (3, N_STAMPS, DB_TRACE_STEPS) then (DB_MAX_GRID,
// DB_TRACE_STEPS) uint64 nanoseconds (0: not written), into `out`; then
// zeroed
extern "C" int speller_bwd_tc_trace(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, db_trace, sizeof(db_trace));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(static_cast<char*>(out) + sizeof(db_trace), db_trace_attend,
                               sizeof(db_trace_attend));
  void* p = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, db_trace);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(db_trace));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, db_trace_attend);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(db_trace_attend));
  return (int)err;
}
#define DB_STAMP(e, s) db_stamp(e, s)
#define DB_STAMP_ATTEND(s) db_stamp_attend(s)
#else
#define DB_STAMP(e, s)
#define DB_STAMP_ATTEND(s)
#endif

// pointer slots of the launch (the order of ops/speller_cuda.py's list)
enum BtPtr {
  B_K, B_V, B_WC1, B_WHH1, B_WIH2, B_WHH2, B_WQ, B_C10, B_C20, B_GATES1, B_C1, B_GATES2, B_C2,
  B_WGTS, B_M1, B_M2, B_DQUP, B_DCTXUP, B_DWUP,
  // outputs
  B_DPRE1, B_DPRE2, B_DQ, B_DCTXTOT, B_DSC, B_DH1, B_DC1, B_DH2, B_DC2, B_DCTX, N_BT_PTRS
};
// int slots
enum BtDim { F_B, F_LDB, F_TE, F_T, F_P, F_HEADS, F_H1, F_H2, F_G, N_BT_DIMS };
// the tensor maps: the three input streams, then the five weights
enum BtMap { M_DQ, M_DPRE2, M_DPRE1, M_WQ, M_WIH2, M_WHH2, M_WHH1, M_WC1, N_MAPS };

struct DecodeBwdTcArgs {
  const void* p[N_BT_PTRS];
  int B, ldb, Te, T, P, heads, H1, H2;  // ldb: the batch the pointers' rows are in
  float scale;
};

struct BwdMaps {
  CUtensorMap m[N_MAPS];
};

// The block's shared memory, in this order after the slack that puts it on
// a 1024-byte boundary: the ring, stages of (the launch's rows rounded up to
// 64 (64 or 128) x 64 k of the input) then (8 x the most groups a block x 64
// k of weight rows); the product's tile (128 rows x that N + 8, fp32); the
// attention's fp32 buffers (d_ctx, dq_att's group sums, dw of every head);
// the mbarriers. The ring takes what the rest leaves of TC_SMEM_LIMIT, at
// most DB_MAX_STAGES.
__host__ __device__ inline int db_box_rows(int B) { return B > 64 ? 128 : 64; }
__host__ __device__ inline int db_groups(int H1, int H2, int P) { return (H1 + H2 + P) / DB_GCOLS; }
__host__ __device__ inline int db_max_groups(int H1, int H2, int P, int G) {
  return (db_groups(H1, H2, P) + G - 1) / G;
}
// The k-th group of block b on G blocks, group b + k G of the db_groups in
// the order cell 1, cell 2, context: its Kind (-1: none) and its first unit
// or context column. speller_bwd_tc_groups reads it back.
struct DbGroup {
  int kind, first;
};
__host__ __device__ inline DbGroup db_group(int H1, int H2, int P, int G, int b, int k) {
  const int NG1 = H1 / DB_GCOLS, NG2 = H2 / DB_GCOLS, gid = b + k * G;
  const int kind = gid >= db_groups(H1, H2, P) ? -1
                   : gid < NG1                  ? G_CELL1
                   : gid < NG1 + NG2            ? G_CELL2
                                                : G_CTX;
  return {kind, DB_GCOLS * (kind == G_CELL1 ? gid : kind == G_CELL2 ? gid - NG1 : gid - NG1 - NG2)};
}
__host__ __device__ inline size_t db_stage_bytes(int B, int gmax) {
  return (size_t)db_box_rows(B) * 128 + (size_t)gmax * DB_GCOLS * 128;
}
__host__ __device__ inline size_t db_red_bytes(int gmax) {
  return (size_t)DB_ROWS * (gmax * DB_GCOLS + 8) * sizeof(float);
}
__host__ __device__ inline size_t db_att_bytes(int Te, int P, int heads) {
  return align16(((size_t)P + NTHREADS * 8 + (size_t)heads * Te) * sizeof(float));
}
__host__ __device__ inline size_t db_fixed_bytes(int Te, int P, int heads, int gmax) {
  return TC_ALIGN + db_red_bytes(gmax) + db_att_bytes(Te, P, heads) + DB_BAR_BYTES;
}
__host__ __device__ inline int db_stages(int B, int Te, int P, int heads, int gmax) {
  const size_t fixed = db_fixed_bytes(Te, P, heads, gmax);
  const int room = fixed < (size_t)TC_SMEM_LIMIT
                       ? (int)((TC_SMEM_LIMIT - fixed) / db_stage_bytes(B, gmax))
                       : 0;
  return room < DB_MAX_STAGES ? room : DB_MAX_STAGES;
}
__host__ __device__ inline size_t db_smem_bytes(int B, int Te, int P, int heads, int gmax) {
  return db_fixed_bytes(Te, P, heads, gmax) +
         (size_t)db_stages(B, Te, P, heads, gmax) * db_stage_bytes(B, gmax);
}

// Phase (a) for batch row r at step t (on the consumers' named barrier): d_ctx = dctx + dctxup[t] (stored, and
// rounded for the product with V), dw = round(d_ctx) . V (+ dwup[t]), the
// softmax adjoint dsc = w * (dw - sum(dw * w)) (stored), dq_att =
// round(dsc * scale) . K, and d_q = dq_att + dqup[t] into the dq stream.
__device__ __forceinline__ void attend_adjoint_row(const DecodeBwdTcArgs& a, int t, int r,
                                                   bool first, float* dch_s, float* gsum_s,
                                                   float* dw_s) {
  using T = __nv_bfloat16;
  constexpr int VEC = 8;
  const int P = a.P, Te = a.Te, heads = a.heads;
  const int d = P / heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* kmat = static_cast<const T*>(a.p[B_K]);
  const T* vmat = static_cast<const T*>(a.p[B_V]);
  const T* wgts = static_cast<const T*>(a.p[B_WGTS]);
  const T* dqup = static_cast<const T*>(a.p[B_DQUP]);
  const T* dctxup = static_cast<const T*>(a.p[B_DCTXUP]);
  const T* dwup = static_cast<const T*>(a.p[B_DWUP]);
  const float* dctx_x = static_cast<const float*>(a.p[B_DCTX]);
  T* dq = static_cast<T*>(const_cast<void*>(a.p[B_DQ]));
  T* dctxtot = static_cast<T*>(const_cast<void*>(a.p[B_DCTXTOT]));
  T* dsc_out = static_cast<T*>(const_cast<void*>(a.p[B_DSC]));
  const long long row = (long long)t * a.ldb + r;  // this step's row of a (T, ldb, .) stream

  for (int p = threadIdx.x; p < P; p += NTHREADS) {
    const float carry = first ? 0.0f : __ldcg(dctx_x + (long long)r * P + p);
    const float d_ctx = carry + ld_nc(dctxup + row * P + p);
    dctxtot[row * P + p] = from_f<T>(d_ctx);
    dch_s[p] = round_to<T>(d_ctx);
  }
  named_barrier(1, DB_CONSUMERS);

  // dw[h][te] = sum_i d_ctx[h, i] * v[te, h, i] (+ dwup)
  const T* vrow = vmat + (long long)r * Te * P;
  for (int item = threadIdx.x; item < heads * Te; item += NTHREADS) {
    const int h = item / Te, te = item % Te;
    const T* vp = vrow + (long long)te * P + h * d;
    const float* cp = dch_s + h * d;
    float s = 0.0f;
#pragma unroll 8
    for (int i = 0; i < d; i += VEC) {
      float vv[VEC];
      load16_nc(vp + i, vv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += __fmul_rn(cp[i + j], vv[j]);
    }
    if (dwup != nullptr) s += ld_nc(dwup + row * heads * Te + item);
    dw_s[item] = s;
  }
  named_barrier(1, DB_CONSUMERS);

  // the softmax adjoint per head (warp h): dsc out in bf16, dsc * scale
  // rounded to bf16 for the product with K, in place of dw
  for (int h = warp; h < heads; h += NWARPS) {
    float* dwh = dw_s + h * Te;
    const T* wh = wgts + row * heads * Te + h * Te;
    float sum = 0.0f;
    for (int te = lane; te < Te; te += 32) sum += dwh[te] * ld_nc(wh + te);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    for (int te = lane; te < Te; te += 32) {
      const float dsc = ld_nc(wh + te) * (dwh[te] - sum);
      dsc_out[row * heads * Te + h * Te + te] = from_f<T>(dsc);
      dwh[te] = round_to<T>(dsc * a.scale);
    }
  }
  named_barrier(1, DB_CONSUMERS);

  // dq_att[p] = sum_te dsc_scaled[h(p)][te] * k[te, p]: thread (group g,
  // slice s) sums frames g, g + groups, ... of the VEC columns of slice s
  // (one head's: d % VEC == 0) in order, U frames' loads in flight; the
  // groups' sums meet in shared memory
  const T* krow = kmat + (long long)r * Te * P;
  const int slices = P / VEC, groups = NTHREADS / slices;
  const int g = threadIdx.x / slices, p0 = (threadIdx.x % slices) * VEC;
  if (g < groups) {
    const float* dh = dw_s + (p0 / d) * Te;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    constexpr int U = 8;  // frames in flight a thread
    for (int te0 = g; te0 < Te; te0 += U * groups) {
      float kv[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int te = te0 + u * groups;
        if (te < Te) load16_nc(krow + (long long)te * P + p0, kv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int te = te0 + u * groups;
        if (te < Te) {
          const float ds = dh[te];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += __fmul_rn(ds, kv[u][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) gsum_s[g * P + p0 + j] = acc[j];
  }
  named_barrier(1, DB_CONSUMERS);
  for (int p = threadIdx.x; p < P; p += NTHREADS) {
    float acc = 0.0f;
    for (int k = 0; k < groups; ++k) acc += gsum_s[k * P + p];
    dq[row * P + p] = from_f<T>(acc + ld_nc(dqup + row * P + p));
  }
  named_barrier(1, DB_CONSUMERS);  // the row's shared buffers are reused by the next row
}

// The gate adjoint of 4 adjacent units u .. u + 3 of batch row `row` at step
// t (speller_bwd.cu's gate_adjoint): sum is their product column (the d_h of
// the dropped output less the dh carry), dh and dc their carries; stores the
// four gates' dpre (rounded to bf16) and leaves the new dc in dc.
__device__ __forceinline__ void gate_adjoint4(const __nv_bfloat16* gates, const __nv_bfloat16* c,
                                              const __nv_bfloat16* c0, const __nv_bfloat16* mask,
                                              __nv_bfloat16* dpre, int t, int ldb, int row, int H,
                                              int u, const float* sum, const float* dh,
                                              float* dc) {
  const long long at = (long long)t * ldb + row;
  float gi[4], gf[4], gg[4], go[4], cv[4], cp[4], keep[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  load_bf16<4>(gates + at * 4 * H + u, gi);
  load_bf16<4>(gates + at * 4 * H + H + u, gf);
  load_bf16<4>(gates + at * 4 * H + 2 * H + u, gg);
  load_bf16<4>(gates + at * 4 * H + 3 * H + u, go);
  load_bf16<4>(c + at * H + u, cv);
  load_bf16<4>(t > 0 ? c + (at - ldb) * H + u : c0 + (long long)row * H + u, cp);
  if (mask != nullptr) load_bf16<4>(mask + at * H + u, keep);
  float pi[4], pf[4], pg[4], po[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d_hd = dh[i] + sum[i];
    const float d_hn = mask != nullptr ? d_hd * keep[i] : d_hd;
    const float tanh_c = tanhf(cv[i]);
    const float dc_tot = dc[i] + d_hn * go[i] * (1.0f - tanh_c * tanh_c);
    pi[i] = dc_tot * gg[i] * gi[i] * (1.0f - gi[i]);
    pf[i] = dc_tot * cp[i] * gf[i] * (1.0f - gf[i]);
    pg[i] = dc_tot * gi[i] * (1.0f - gg[i] * gg[i]);
    po[i] = d_hn * tanh_c * go[i] * (1.0f - go[i]);
    dc[i] = dc_tot * gf[i];
  }
  __nv_bfloat16* out = dpre + at * 4 * H + u;
  store_bf16<4>(out, pi);
  store_bf16<4>(out + H, pf);
  store_bf16<4>(out + 2 * H, pg);
  store_bf16<4>(out + 3 * H, po);
}

__global__ void __launch_bounds__(DB_THREADS, 1)
    speller_bwd_tc_kernel(DecodeBwdTcArgs a, const __grid_constant__ BwdMaps maps, unsigned* ctr) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(TC_ALIGN) unsigned char smem_raw[];

  const int B = a.B, ldb = a.ldb, P = a.P, H1 = a.H1, H2 = a.H2, nsteps = a.T;
  const int G = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gmax = db_max_groups(H1, H2, P, G);
  const int S = db_stages(B, a.Te, P, a.heads, gmax);
  const int stage_bytes = (int)db_stage_bytes(B, gmax);
  const int a_bytes = db_box_rows(B) * 128;

  unsigned char* ring =
      smem_raw + ((TC_ALIGN - (smem_u32(smem_raw) & (TC_ALIGN - 1))) & (TC_ALIGN - 1));
  float* red_s = reinterpret_cast<float*>(ring + (size_t)S * stage_bytes);
  float* dch_s = red_s + db_red_bytes(gmax) / sizeof(float);
  float* gsum_s = dch_s + P;
  float* dw_s = gsum_s + NTHREADS * 8;
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(dch_s) +
                                               db_att_bytes(a.Te, P, a.heads));
  const uint32_t ring_addr = smem_u32(ring);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + DB_MAX_STAGES);

  // this block's groups (k-th: group blockIdx.x + k G), each's kind and
  // first unit (or context column), and its column in each phase's product
  // (-1: not in that phase)
  int kind[DB_MAX_GROUPS], first[DB_MAX_GROUPS], col_b[DB_MAX_GROUPS], col_c[DB_MAX_GROUPS],
      col_d[DB_MAX_GROUPS];
  int nb = 0, nc = 0, nd = 0;
#pragma unroll
  for (int k = 0; k < DB_MAX_GROUPS; ++k) {
    const DbGroup grp = db_group(H1, H2, P, G, blockIdx.x, k);
    kind[k] = grp.kind;
    first[k] = grp.first;
    col_b[k] = kind[k] == G_CELL2 ? DB_GCOLS * nb++ : -1;
    col_c[k] = kind[k] == G_CELL1 || kind[k] == G_CELL2 ? DB_GCOLS * nc++ : -1;
    col_d[k] = kind[k] == G_CELL1 || kind[k] == G_CTX ? DB_GCOLS * nd++ : -1;
  }

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, DB_CONSUMERS / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // ---- the producer: lane 0 of the last warp fills the ring, in the order
  // the consumers take the chunks: each stage the input's box and the
  // block's weight rows of the phase for the same 64 k
  if (warp == DB_CONSUMERS / 32) {
    if (lane == 0) {
      int slot = 0;
      unsigned phase = 0;
      auto fill = [&](int input, int kc, int t, int nw, const int* wmap, const int* wrow) {
        mbar_wait(empty0 + 8 * slot, phase ^ 1);
        const uint32_t full = full0 + 8 * slot, dst = ring_addr + slot * stage_bytes;
        mbar_arrive_expect_tx(full, a_bytes + nw * DB_GCOLS * 128);
        tma_load_3d(dst, &maps.m[input], full, kc, 0, t);
        for (int j = 0; j < nw; ++j)
          tma_load_3d(dst + a_bytes + j * DB_GCOLS * 128, &maps.m[wmap[j]], full, kc, wrow[j], 0);
        if (++slot == S) slot = 0, phase ^= 1;
      };
      auto await = [&](int c, unsigned target) {
        while (load_acquire(ctr + c) < target) {
        }
        fence_proxy_async_global();  // the acquire, then the TMA reads of what it published
      };
      // each phase's weight boxes, in the order of its product's columns
      int wb[DB_MAX_GROUPS], rb[DB_MAX_GROUPS], wc[DB_MAX_GROUPS], rc[DB_MAX_GROUPS],
          wd[DB_MAX_GROUPS], rd[DB_MAX_GROUPS];
      for (int k = 0; k < DB_MAX_GROUPS; ++k) {
        if (col_b[k] >= 0) wb[col_b[k] / DB_GCOLS] = M_WQ, rb[col_b[k] / DB_GCOLS] = first[k];
        if (col_c[k] >= 0)
          wc[col_c[k] / DB_GCOLS] = kind[k] == G_CELL1 ? M_WIH2 : M_WHH2,
          rc[col_c[k] / DB_GCOLS] = first[k];
        if (col_d[k] >= 0)
          wd[col_d[k] / DB_GCOLS] = kind[k] == G_CELL1 ? M_WHH1 : M_WC1,
          rd[col_d[k] / DB_GCOLS] = first[k];
      }
      for (int s = 0; s < nsteps; ++s) {
        const int t = nsteps - 1 - s;
        const unsigned done = (unsigned)(s + 1) * G;
        if (nb > 0) {
          await(C_ATTEND, done);
          DB_STAMP(S_PRODUCER_ATTEND, s);
          for (int c = 0; c < P / DB_KC; ++c) fill(M_DQ, c * DB_KC, t, nb, wb, rb);
        }
        if (nc > 0) {
          await(C_CELL2, done);
          DB_STAMP(S_PRODUCER_CELL2, s);
          for (int c = 0; c < 4 * H2 / DB_KC; ++c) fill(M_DPRE2, c * DB_KC, t, nc, wc, rc);
        }
        if (nd > 0) {
          await(C_CELL1, done);
          DB_STAMP(S_PRODUCER_CELL1, s);
          for (int c = 0; c < 4 * H1 / DB_KC; ++c) fill(M_DPRE1, c * DB_KC, t, nd, wd, rd);
        }
      }
    }
    return;
  }

  // ---- the consumers
  const int wg = warp / 4;
  const bool split = B <= 64;     // both warpgroups on rows 0..63, the k-chunks split
  const int rg = split ? 0 : wg;  // the 64 rows of the warpgroup's products
  // a thread's units: 4 adjacent ones of each of its groups (from 4 half),
  // of row `row`, with their fp32 dh and dc carries
  const int row = tid >> 1, half = tid & 1;
  const bool live = row < B;
  float dh[DB_MAX_GROUPS][4], dc[DB_MAX_GROUPS][4];
#pragma unroll
  for (int k = 0; k < DB_MAX_GROUPS; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) dh[k][i] = dc[k][i] = 0.0f;
  const T* gates1 = static_cast<const T*>(a.p[B_GATES1]);
  const T* c1 = static_cast<const T*>(a.p[B_C1]);
  const T* c10 = static_cast<const T*>(a.p[B_C10]);
  const T* m1 = static_cast<const T*>(a.p[B_M1]);
  const T* gates2 = static_cast<const T*>(a.p[B_GATES2]);
  const T* c2 = static_cast<const T*>(a.p[B_C2]);
  const T* c20 = static_cast<const T*>(a.p[B_C20]);
  const T* m2 = static_cast<const T*>(a.p[B_M2]);
  T* dpre1 = static_cast<T*>(const_cast<void*>(a.p[B_DPRE1]));
  T* dpre2 = static_cast<T*>(const_cast<void*>(a.p[B_DPRE2]));
  float* dctx_x = static_cast<float*>(const_cast<void*>(a.p[B_DCTX]));

  int slot = 0;
  unsigned phase = 0;
  // one product: the next `nk` chunks of the ring (input against the weight
  // rows beside it, N columns), the warpgroups' sums into the tile: warpgroup
  // wg's rows at tile rows 64 wg + (0..63) (its own rows past 64 rows of
  // batch, the same rows 0..63 as the other warpgroup's up to 64)
  auto product = [&](auto ncols, int nk) {
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
        const uint32_t b_t = ring_addr + slot * stage_bytes + a_bytes;
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
    named_barrier(1, DB_CONSUMERS);
  };
  auto run_product = [&](int n, int nk) {
    switch (n) {
      case 1: product(Cols<8>{}, nk); break;
      case 2: product(Cols<16>{}, nk); break;
      case 3: product(Cols<24>{}, nk); break;
      case 4: product(Cols<32>{}, nk); break;
    }
  };
  // the thread's 4 sums of tile column `col` (of a product of n groups), in
  // the fixed order
  auto sums = [&](int n, int col, float* v) {
    const int rs = n * DB_GCOLS + 8;
    const float4 p = *reinterpret_cast<const float4*>(red_s + row * rs + col + 4 * half);
    v[0] = p.x, v[1] = p.y, v[2] = p.z, v[3] = p.w;
    if (split) {
      const float4 o = *reinterpret_cast<const float4*>(red_s + (64 + row) * rs + col + 4 * half);
      v[0] += o.x, v[1] += o.y, v[2] += o.z, v[3] += o.w;
    }
  };
  // the end of a phase: the block's stores are published through counter c
  auto publish = [&](int c) {
    fence_proxy_async_global();  // stores read by other blocks' TMA
    named_barrier(1, DB_CONSUMERS);
    if (tid == 0) arrive_release(ctr + c);
  };

  for (int s = 0; s < nsteps; ++s) {
    const int t = nsteps - 1 - s;
    DB_STAMP(S_STEP, s);
    // (a): the attention adjoint of the block's rows, after dctx of step s - 1
    if (s > 0) {
      if (tid == 0) {
        const unsigned target = (unsigned)s * G;
        while (load_acquire(ctr + C_BACK) < target) {
        }
      }
      named_barrier(1, DB_CONSUMERS);
    }
    DB_STAMP(S_BACK_ACQUIRED, s);
    for (int r = blockIdx.x; r < B; r += G)
      attend_adjoint_row(a, t, r, s == 0, dch_s, gsum_s, dw_s);
    publish(C_ATTEND);
    DB_STAMP(S_ATTEND_PUBLISHED, s);
    DB_STAMP_ATTEND(s);

    // (b): d_q @ wq^T, cell 2's gate adjoint
    if (nb > 0) {
      run_product(nb, P / DB_KC);
      DB_STAMP(S_CELL2_PRODUCT, s);
      if (live) {
#pragma unroll
        for (int k = 0; k < DB_MAX_GROUPS; ++k) {
          if (col_b[k] < 0) continue;
          float v[4];
          sums(nb, col_b[k], v);
          gate_adjoint4(gates2, c2, c20, m2, dpre2, t, ldb, row, H2, first[k] + 4 * half, v,
                        dh[k], dc[k]);
        }
      }
    }
    publish(C_CELL2);
    DB_STAMP(S_CELL2_PUBLISHED, s);

    // (c): dpre2 @ [wih2; whh2]^T, cell 1's gate adjoint and the new dh2
    if (nc > 0) {
      run_product(nc, 4 * H2 / DB_KC);
      DB_STAMP(S_CELL1_PRODUCT, s);
      if (live) {
#pragma unroll
        for (int k = 0; k < DB_MAX_GROUPS; ++k) {
          if (col_c[k] < 0) continue;
          float v[4];
          sums(nc, col_c[k], v);
          if (kind[k] == G_CELL1) {
            gate_adjoint4(gates1, c1, c10, m1, dpre1, t, ldb, row, H1, first[k] + 4 * half, v,
                          dh[k], dc[k]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) dh[k][i] = v[i];
          }
        }
      }
    }
    publish(C_CELL1);
    DB_STAMP(S_CELL1_PUBLISHED, s);

    // (d): dpre1 @ [whh1; wc1]^T: the new dh1 and dctx
    if (nd > 0) {
      run_product(nd, 4 * H1 / DB_KC);
      DB_STAMP(S_BACK_PRODUCT, s);
      if (live) {
#pragma unroll
        for (int k = 0; k < DB_MAX_GROUPS; ++k) {
          if (col_d[k] < 0) continue;
          float v[4];
          sums(nd, col_d[k], v);
          if (kind[k] == G_CELL1) {
#pragma unroll
            for (int i = 0; i < 4; ++i) dh[k][i] = v[i];
          } else {
            *reinterpret_cast<float4*>(dctx_x + (long long)row * P + first[k] + 4 * half) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      }
    }
    publish(C_BACK);
    DB_STAMP(S_BACK_PUBLISHED, s);
  }

  // the carries after t = 0: dh10, dc10, dh20, dc20 (dctx0 is the exchange)
  if (live) {
#pragma unroll
    for (int k = 0; k < DB_MAX_GROUPS; ++k) {
      if (kind[k] != G_CELL1 && kind[k] != G_CELL2) continue;
      const bool one = kind[k] == G_CELL1;
      const int H = one ? H1 : H2;
      float* dh_out = static_cast<float*>(const_cast<void*>(a.p[one ? B_DH1 : B_DH2]));
      float* dc_out = static_cast<float*>(const_cast<void*>(a.p[one ? B_DC1 : B_DC2]));
      const long long o = (long long)row * H + first[k] + 4 * half;
      *reinterpret_cast<float4*>(dh_out + o) = make_float4(dh[k][0], dh[k][1], dh[k][2], dh[k][3]);
      *reinterpret_cast<float4*>(dc_out + o) = make_float4(dc[k][0], dc[k][1], dc[k][2], dc[k][3]);
    }
  }
}

// the map of a (slots, ldb, X) bf16 stream from the launch's first row:
// boxes of 64 columns x the launch's rows rounded up to 64 x one slot, the
// 128-byte swizzle; rows past the launch's read as zeros. A weight (rows, X)
// is the same with one slot and boxes of 8 rows.
static bool encode_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, int X, int rows,
                       int ld, int slots, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)X, (cuuint64_t)rows, (cuuint64_t)slots};
  const cuuint64_t strides[2] = {(cuuint64_t)X * 2, (cuuint64_t)X * 2 * ld};
  const cuuint32_t box[3] = {DB_KC, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The geometry the wrapper (ops/speller_cuda.py::plan_decode_bwd_tc)
// mirrors, and the shared memory a block of `device` may opt into: out =
// {DB_ROWS, DB_MAX_GRID, DB_KC, DB_GCOLS, DB_MAX_GROUPS, DB_MAX_STAGES,
// DB_MIN_STAGES, TC_SMEM_LIMIT, DB_THREADS, opt-in bytes, SMs}. Returns a
// cudaError_t (0 on success).
extern "C" int speller_bwd_tc_limits(int device, long long* out) {
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long v[] = {DB_ROWS,       DB_MAX_GRID,   DB_KC,      DB_GCOLS, DB_MAX_GROUPS,
                         DB_MAX_STAGES, DB_MIN_STAGES, TC_SMEM_LIMIT, DB_THREADS, optin, sms};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return (int)err;
}

// Each block's groups on G blocks, as the kernel assigns them (db_group):
// out[(b * DB_MAX_GROUPS + k) * 2 + {0, 1}] = the Kind (-1: none) and the
// first unit or context column of block b's k-th group, G * DB_MAX_GROUPS
// pairs.
extern "C" void speller_bwd_tc_groups(int H1, int H2, int P, int G, int* out) {
  for (int b = 0; b < G; ++b)
    for (int k = 0; k < DB_MAX_GROUPS; ++k) {
      const DbGroup grp = db_group(H1, H2, P, G, b, k);
      out[(b * DB_MAX_GROUPS + k) * 2] = grp.kind;
      out[(b * DB_MAX_GROUPS + k) * 2 + 1] = grp.first;
    }
}

// bytes of dynamic shared memory of a launch of B rows on G blocks
extern "C" size_t speller_bwd_tc_smem_bytes(int B, int Te, int P, int heads, int H1, int H2,
                                            int G) {
  return db_smem_bytes(B, Te, P, heads, db_max_groups(H1, H2, P, G));
}

// One launch of B <= DB_ROWS rows on dims[F_G] blocks. ptrs: N_BT_PTRS
// device pointers in enum BtPtr order, each at the launch's first row (B_M1,
// B_M2 and B_DWUP may be null); the (T, ldb, .) streams and the (ldb, .)
// carries have ldb rows. dims: N_BT_DIMS ints in enum BtDim order. ctr:
// N_CTRS zeroed counters. The wrapper checks the shapes first
// (plan_decode_bwd_tc); what this refuses returns cudaErrorInvalidValue.
// Returns a cudaError_t (0 on success).
extern "C" int speller_bwd_tc_launch(const void* const* ptrs, const int* dims, float scale,
                                     void* ctr, void* stream) {
  DecodeBwdTcArgs a;
  for (int i = 0; i < N_BT_PTRS; ++i) a.p[i] = ptrs[i];
  a.B = dims[F_B];
  a.ldb = dims[F_LDB];
  a.Te = dims[F_TE];
  a.T = dims[F_T];
  a.P = dims[F_P];
  a.heads = dims[F_HEADS];
  a.H1 = dims[F_H1];
  a.H2 = dims[F_H2];
  a.scale = scale;
  const int G = dims[F_G];
  const bool shape_ok = a.B >= 1 && a.B <= DB_ROWS && a.ldb >= a.B && a.T >= 1 && a.Te >= 1 &&
                        a.H1 % DB_KC == 0 && a.H2 % DB_KC == 0 && a.P % DB_KC == 0 &&
                        a.H1 >= DB_KC && a.H2 >= DB_KC && a.P >= DB_KC && G >= 1 &&
                        G <= DB_MAX_GRID && db_max_groups(a.H1, a.H2, a.P, G) <= DB_MAX_GROUPS &&
                        a.heads >= 1 && a.P % a.heads == 0 && (a.P / a.heads) % 8 == 0 &&
                        a.P <= NTHREADS * 8 &&
                        db_stages(a.B, a.Te, a.P, a.heads, db_max_groups(a.H1, a.H2, a.P, G)) >=
                            DB_MIN_STAGES;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  BwdMaps maps;
  const int box = db_box_rows(a.B);
  if (!encode_map(encode, &maps.m[M_DQ], a.p[B_DQ], a.P, a.B, a.ldb, a.T, box) ||
      !encode_map(encode, &maps.m[M_DPRE2], a.p[B_DPRE2], 4 * a.H2, a.B, a.ldb, a.T, box) ||
      !encode_map(encode, &maps.m[M_DPRE1], a.p[B_DPRE1], 4 * a.H1, a.B, a.ldb, a.T, box) ||
      !encode_map(encode, &maps.m[M_WQ], a.p[B_WQ], a.P, a.H2, a.H2, 1, DB_GCOLS) ||
      !encode_map(encode, &maps.m[M_WIH2], a.p[B_WIH2], 4 * a.H2, a.H1, a.H1, 1, DB_GCOLS) ||
      !encode_map(encode, &maps.m[M_WHH2], a.p[B_WHH2], 4 * a.H2, a.H2, a.H2, 1, DB_GCOLS) ||
      !encode_map(encode, &maps.m[M_WHH1], a.p[B_WHH1], 4 * a.H1, a.H1, a.H1, 1, DB_GCOLS) ||
      !encode_map(encode, &maps.m[M_WC1], a.p[B_WC1], 4 * a.H1, a.P, a.P, 1, DB_GCOLS))
    return (int)cudaErrorInvalidValue;
  auto kernel = speller_bwd_tc_kernel;
  const size_t smem = db_smem_bytes(a.B, a.Te, a.P, a.heads, db_max_groups(a.H1, a.H2, a.P, G));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  unsigned* c = static_cast<unsigned*>(ctr);
  void* params[] = {&a, &maps, &c};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(G), dim3(DB_THREADS),
                                    params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
