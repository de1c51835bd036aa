// Fused speller decode for Hopper (sm_90a), float32: one cooperative launch
// runs every step of the decode for the whole batch, in an eval and a
// training form. bfloat16 runs on speller_decode_tc.cu (the products on
// tensor cores, counters in place of the grid barriers).
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/speller_pallas.py):
//   _decode_fwd_kernel (:90) as _fwd_chunk (:465) launches it: TPU kernel #8.
//   Each step selects the input id (a forced id >= 0, else the id fed back by
//   the previous step; <sos> at step 0), runs cell 1, cell 2, the query
//   projection, the masked-softmax cross-attention of every head, the tied
//   classifier and the first-max argmax that feeds the next step.
//   TRAIN = false is the eval form (save_residuals=False, no dropout).
//   TRAIN = true is the training form (save_residuals=True): each cell's
//   output is multiplied by the step's dropout mask in fp32 (h1d = h1n *
//   m1[t], h2d = h2n * m2[t]; the dropped value is the carry), and the streams
//   the adjoint (speller_bwd.cu) reads are stored in the weight dtype: the fed
//   id, both cells' activated gates [i, f, g, o] and c, h1d, h2d and the
//   context. The fed id (L, B) int32 stands for the Pallas kernel's one-hot
//   `sel` (L, B, Vp): the gradient of embw1 gathers by it. h1d, h2d and the
//   context streams double as the exchange buffers between blocks, so the
//   training form stores only the gates, c and the id beyond what the eval
//   form writes. Without masks and forcing its logits and weights are
//   bit-equal to the eval form's.
//
// Numerics follow the Pallas kernel (and ops/speller_cuda.py's plain
// version): carries h1, c1, h2, c2, ctx in fp32, rounded to the weight dtype
// only as dot operands; fp32 dot accumulation and gates; q in fp32; per-head
// scores as fp32 products of q rounded to the weight dtype and K, summed in
// fp32, times the fp32 scale, plus the fp32 bias; softmax e / sum; the
// context as fp32 products of the weights rounded to the weight dtype and V,
// summed in fp32 (products unfused from the sum, as XLA forms them in the
// Pallas kernel's interpret mode); the classifier over cat(q, ctx) rounded to
// the weight dtype; the feedback is the first maximum of the fp32 logits.
// Logits and weights are stored in the weight dtype.
//
// What bounds it. A step is four dependent phases (cell 1, cell 2, the
// query, then per batch row the attention, the classifier and the argmax
// that feeds the next step), each ended by a grid barrier. At the Rewriter's
// widths (H1 256, H2 128, P 128, 1 head), B = 256, Te = 608, a step is ~197M
// FMAs (~6 us at the card's 67 TFLOP/s float32 peak), three quarters of them
// in the cells; and the attention reads every row's K and V again each step,
// ~93 MB of valid frames at lines of 100-600 characters, more than L2 holds:
// ~28 us a step at 3.35 TB/s, the floor of this design. The earlier body
// gave each of 128 blocks a few columns and walked all B rows, two a warp,
// in every phase: ~200 us a step at B = 256.
//
// Design. G = CG x RG blocks, every one resident (the Python plan,
// ops/speller_cuda.py::plan_decode_f32, picks CG, RG and the tiles below:
// 16 column groups x 8 row groups at the Rewriter's widths, B = 256). Block
// (rg, cg) owns U1 = H1 / CG units of cell 1, U2 = H2 / CG of cell 2 and
// NQ = P / CG query columns, keeps those columns of [wc1; whh1], [wih2;
// whh2] and wq in shared memory for the whole launch ([k][unit][gate]: the
// four gates of a unit side by side), and takes batch rows [rg R, rg R + R),
// R = ceil(B / RG). Per step:
//   1-3. cell 1, cell 2 and the query over the block's rows, in sub-tiles of
//        S rows: the rows' input vectors ([ctx; h1], [h1; h2], h2) stream in
//        128-column chunks through a ring of up to four shared-memory stages
//        (cp.async, L2 only), the next chunks in flight while one is
//        multiplied; thread (j, g) keeps a register tile of rows g + i S /
//        RT (i < RT) by the four gates of unit j (the query: a group of 4, 2
//        or 1 columns) and accumulates it in fp32 over the whole k range, so
//        no warp walks rows and nothing is summed across threads; it then
//        applies the gates to its tile (the fed id's embw1 row, c and the
//        mask loaded before the product, behind its latency). RT is 4 where
//        the product still keeps four warps busy, else 2 or 1
//        (df_tile_rows);
//   4. the attention: block b takes, of the rows in order of their extent
//      (longest first, ranked once at the start), positions b and 2G - 1 - b
//      of every 2G (a snake), so that every block streams about as many
//      frames of K and V; up to four rows at once (two at B = 256 on 128
//      blocks), each sub-phase over all of them together: scores (thread per
//      row, head and frame, two frames at a time, 16 loads of each in
//      flight), softmax (warp per row and head), context (thread per row,
//      frame group and 16-byte slice, 16 frames' loads in flight, the groups
//      summed in shared memory), classifier (warp per slice of the 2P
//      inputs, lane per vocabulary entry), first-max argmax. A row's frames
//      past its last unmasked one (its extent) are neither read nor summed
//      and their weights are written as 0: their bias is NEG, so exp(NEG +
//      s - max) is exactly 0 there, in the plain version too.
// One grid-wide barrier (cooperative groups) ends each phase. Plain FMA on
// the CUDA cores, no TF32 (float32 keeps its 1e-4 tolerance). The eval and
// the training forms run the same code on the same geometry (the plan does
// not depend on the form), so without masks and forcing their logits are
// bit-equal.

#include <cooperative_groups.h>

#include "speller_common.cuh"
#include "wgmma_common.cuh"  // smem_u32

namespace cg = cooperative_groups;

constexpr int DF_THREADS = 256;
constexpr int DF_WARPS = DF_THREADS / 32;
constexpr int DF_RT = 4;          // batch rows of a thread's product tile, at most
constexpr int DF_BUSY = 128;      // threads a product keeps busy where it can (4 warps)
constexpr int DF_KC = 128;        // columns of an input vector a ring stage holds
constexpr int DF_PAD = 4;         // floats of padding after a staged row
constexpr int DF_MAX_STAGES = 4;  // ring stages, at most
constexpr int DF_MAX_GRID = 128;  // blocks of a launch, at most
constexpr int DF_ATT_ROWS = 4;    // attention rows a block takes at once, at most
constexpr int DF_VMAX = 32;       // padded vocabulary: one lane per entry
constexpr float DF_MASKED = -5e8f;  // a bias at or below it masks its frame (NEG = -1e9)

// Phase stamps for tools/trace_speller_decode.py (--float32). Built with
// -DDF_TRACE, thread 0 of blocks 0, G / 2 and G - 1 writes %globaltimer at
// each phase boundary of the first DF_TRACE_STEPS steps (the attention's
// stamps: its last pass of rows); without it DF_STAMP is nothing and the
// kernels are the same.
enum Stamp {
  S_STEP, S_CELL1, S_CELL1_SYNCED, S_CELL2, S_CELL2_SYNCED, S_QUERY, S_QUERY_SYNCED,
  S_Q_LOADED, S_SCORES, S_SOFTMAX, S_CONTEXT, S_CLASSIFIER, S_ATTEND, N_STAMPS
};
#ifdef DF_TRACE
constexpr int DF_TRACE_STEPS = 1024;
__device__ unsigned long long df_trace[3][N_STAMPS][DF_TRACE_STEPS];
__device__ __forceinline__ void df_stamp(int e, int t) {
  const int b = blockIdx.x == 0 ? 0 : blockIdx.x == gridDim.x / 2 ? 1
                                    : blockIdx.x == gridDim.x - 1 ? 2 : -1;
  if (b < 0 || t >= DF_TRACE_STEPS || threadIdx.x != 0) return;
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  df_trace[b][e][t] = v;
}
// the stamps, (3, N_STAMPS, DF_TRACE_STEPS) uint64 nanoseconds (0: not
// written), into `out`; then zeroed
extern "C" int speller_decode_trace(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, df_trace, sizeof(df_trace));
  void* p = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, df_trace);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(df_trace));
  return (int)err;
}
#define DF_STAMP(e, t) df_stamp(e, t)
#else
#define DF_STAMP(e, t)
#endif

// pointer slots of the launch (the order of ops/speller_cuda.py's list)
enum Ptr {
  P_K, P_V, P_BIAS, P_CTX0, P_H10, P_C10, P_H20, P_C20, P_EMBW1, P_WC1, P_WHH1, P_WIH2,
  P_WHH2, P_B2, P_WQ, P_BQ, P_WCLS, P_CLSB, P_FORCED, P_LOGITS, P_WGTS, P_IDS, P_H1X,
  P_H2X, P_CTXX, P_QX, P_C1, P_C2, P_PREV,
  // the training form's masks (null: no dropout) and residual streams
  P_M1, P_M2, P_SEL, P_GATES1, P_C1R, P_H1D, P_GATES2, P_C2R, P_H2D, P_CTXR,
  // scratch: each row's extent (B,) int32, and the rows in order of extent
  // (B,) int32, longest first
  P_EXT, P_PERM, N_PTRS
};
// int slots
enum Dim { D_B, D_TE, D_T, D_P, D_HEADS, D_H1, D_H2, D_VP, D_SOS, N_DIMS };
// the plan's geometry: column groups, row groups, rows a row group, rows a
// product sub-tile, ring stages, attention rows a block at once
enum GeomSlot { G_CG, G_RG, G_ROWS, G_SUB, G_STAGES, G_ATT, N_GEOM };

struct DecodeArgs {
  const void* p[N_PTRS];
  int B, Te, T, P, heads, H1, H2, Vp, sos;
  float scale;
};

struct Geom {
  int cg, rg, rows, sub, stages, att;
};

// The training form's streams of one cell at one step: the dropout mask (B, H)
// (null: none), the activated gates (B, 4H), c (B, H) and, for cell 1, the fed
// id (B,).
struct CellStreams {
  const float* mask;
  float* gates;
  float* c;
  int* sel;
};

// The width of the column groups of a product: a cell's unit is its four
// gates; the query's NQ = P / CG columns go in groups of 4, 2 or 1, the
// widest that divides NQ.
__host__ __device__ inline int df_query_width(int NQ) {
  return NQ % 4 == 0 ? 4 : NQ % 2 == 0 ? 2 : 1;
}

// Rows of a thread's tile in a product of Q column groups over sub-tiles of
// `sub` rows: DF_RT where that still keeps DF_BUSY threads busy, else 2 or
// 1 (fewer rows a thread, more threads: four rows a thread on a 32 x 64 x
// 384 tile beat two and eight on an H100, but not where the tiles would
// leave the SM's schedulers idle)
__host__ __device__ inline int df_tile_rows(int sub, int Q) {
  return sub / 4 * Q >= DF_BUSY ? 4 : sub / 2 * Q >= DF_BUSY ? 2 : 1;
}

// a compile-time count (tile rows, a group's width), handed to a generic
// lambda
template <int V>
struct Count {
  static constexpr int value = V;
};
template <typename F>
__device__ __forceinline__ void with_tile_rows(int sub, int Q, F&& f) {
  switch (df_tile_rows(sub, Q)) {
    case 4: f(Count<4>()); break;
    case 2: f(Count<2>()); break;
    default: f(Count<1>()); break;
  }
}

// shared memory of a block (ops/speller_cuda.py::decode_f32_smem_bytes
// mirrors it): the three weight slices ([k][group][width]), then one region
// that the products' ring (stages x sub rows x (DF_KC + DF_PAD)) and the
// attention's buffers (att rows of q, ctx, classifier partials and scores,
// and the context's group sums) take in turn
__host__ __device__ inline size_t df_smem_bytes(int Te, int P, int heads, int H1, int H2,
                                                int cgroups, int sub, int stages, int att) {
  const size_t U1 = H1 / cgroups, U2 = H2 / cgroups, NQ = P / cgroups;
  const size_t weights = 4 * U1 * (P + H1) + 4 * U2 * (H1 + H2) + NQ * H2;
  const size_t ring = (size_t)stages * sub * (DF_KC + DF_PAD);
  const size_t attn = (size_t)att * (2 * P + DF_WARPS * DF_VMAX + heads * Te) + DF_THREADS * 4;
  return (weights + (ring > attn ? ring : attn)) * sizeof(float);
}

__device__ __forceinline__ void df_cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void df_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// at most n (0 .. DF_MAX_STAGES - 1) groups still pending
__device__ __forceinline__ void df_cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// acc[i][c] += x[r + g + i S / 4][k] * w_s[k][j][c] over k < K0 + K1 for the
// sub-tile's n rows from r: x = [x0 | x1] (rows K0 and K1 floats apart in
// global memory) streamed in DF_KC-column chunks through the ring; w_s holds
// Q column groups of W a k. Thread (j, g) keeps a register tile of rows g +
// i S / RT (i < RT) by group j (strided rows: a warp's rows adjacent, its
// 16-byte loads conflict-free): RT + 4 W / 4 shared loads for 4 RT W FMAs
// every four k. Rows past n are not loaded (stale in the ring, computed by no
// live thread). Every thread of the block calls it; `active` ones (g < S /
// RT) accumulate.
template <int RT, int W>
__device__ __forceinline__ void staged_product(float (&acc)[RT][W], const float* x0, int K0,
                                               const float* x1, int K1, int r, int n, int Q,
                                               int j, int g, bool active, const Geom& geo,
                                               float* ring, const float* w_s) {
  constexpr int LDX = DF_KC + DF_PAD;
  const int S = geo.sub, stages = geo.stages, K = K0 + K1;
  const int n_chunks = (K + DF_KC - 1) / DF_KC;
  const int rstride = S / RT;
  auto issue = [&](int c) {
    float* st = ring + (c % stages) * S * LDX;
    const int k0 = c * DF_KC, pieces = min(DF_KC, K - k0) / 4;
    for (int p = threadIdx.x; p < n * pieces; p += DF_THREADS) {
      const int rr = p / pieces, k = k0 + (p % pieces) * 4;
      const float* src = k < K0 ? x0 + (long long)(r + rr) * K0 + k
                                : x1 + (long long)(r + rr) * K1 + (k - K0);
      df_cp_async16(st + rr * LDX + (k - k0), src);
    }
    df_cp_async_commit();
  };
  auto step4 = [&](const float* st, const float* wp, int k) {
    float4 xv[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      xv[i] = *reinterpret_cast<const float4*>(st + i * rstride * LDX + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wk = wp + (k + kk) * Q * W;
      float w[W];
      if constexpr (W == 4) {
        const float4 v = *reinterpret_cast<const float4*>(wk);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      } else if constexpr (W == 2) {
        const float2 v = *reinterpret_cast<const float2*>(wk);
        w[0] = v.x, w[1] = v.y;
      } else {
        w[0] = *wk;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float xk = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
        for (int c = 0; c < W; ++c) acc[i][c] = fmaf(xk, w[c], acc[i][c]);
      }
    }
  };
  for (int c = 0; c < stages && c < n_chunks; ++c) issue(c);
  for (int c = 0; c < n_chunks; ++c) {
    df_cp_async_wait(min(stages, n_chunks - c) - 1);
    __syncthreads();
    if (active) {
      const int k0 = c * DF_KC, kc = min(DF_KC, K - k0);
      const float* st = ring + (c % stages) * S * LDX + g * LDX;
      const float* wp = w_s + ((long long)k0 * Q + j) * W;
      // not unrolled: unrolling the chunk loop made the Rewriter's step
      // slower on an H100 (the kernel's code outgrows the instruction cache)
      for (int k = 0; k < kc; k += 4) step4(st, wp, k);
    }
    __syncthreads();  // the stage is read: refill it
    if (c + stages < n_chunks) issue(c + stages);
  }
}

// One LSTM cell step for the rows [r_begin, r_end) and this block's U units
// [u0, u0 + U): pre = [x0 | x1] . W_s + extra, gates [i, f, g, o] in fp32.
// extra is embw1's row of the input id (cell 1: forced id, else the
// fed-back one) or b2 (cell 2, prev == nullptr). TRAIN: h is multiplied by
// the mask before it is stored, and the gates, c and (the block of column
// group 0) the fed id are stored. The thread of a tile applies the gates to
// it; its rows' extras and carries load before the product, behind its
// latency.
template <bool TRAIN, int RT>
__device__ __forceinline__ void cell_phase(const float* w_s, int U, const float* x0, int K0,
                                           const float* x1, int K1, int H, int u0,
                                           const float* extra, const int* forced_t,
                                           const int* prev, float* c, float* h_next, int r_begin,
                                           int r_end, const Geom& geo, float* ring,
                                           const CellStreams& st, bool writes_sel) {
  const int j = threadIdx.x % U, g = threadIdx.x / U;
  const int rstride = geo.sub / RT;
  const bool active = g < rstride;
  for (int r = r_begin; r < r_end; r += geo.sub) {
    const int n = min(geo.sub, r_end - r);
    int rows[RT];
    bool live[RT];
    float ex[RT][4], c_old[RT], keep[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      rows[i] = r + g + i * rstride;
      live[i] = active && g + i * rstride < n;
      keep[i] = 1.0f;
      c_old[i] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) ex[i][q] = 0.0f;
      if (live[i]) {
        int id = 0;
        if (prev != nullptr) {
          id = forced_t != nullptr ? forced_t[rows[i]] : -1;
          if (id < 0) id = __ldcg(prev + rows[i]);
          if (TRAIN && writes_sel && j == 0) st.sel[rows[i]] = id;
        }
        const long long at = (long long)rows[i] * H + u0 + j;
        if (TRAIN && st.mask != nullptr) keep[i] = st.mask[at];
#pragma unroll
        for (int q = 0; q < 4; ++q) ex[i][q] = extra[(long long)id * 4 * H + q * H + u0 + j];
        c_old[i] = c[at];
      }
    }
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    staged_product<RT, 4>(acc, x0, K0, x1, K1, r, n, U, j, g, active, geo, ring, w_s);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      if (!live[i]) continue;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) pre[q] = acc[i][q] + ex[i][q];
      const float ig = sigmoidf(pre[0]);
      const float fg = sigmoidf(pre[1]);
      const float gg = tanhf(pre[2]);
      const float og = sigmoidf(pre[3]);
      const float cn = fg * c_old[i] + ig * gg;
      const long long at = (long long)rows[i] * H + u0 + j;
      c[at] = cn;
      float hn = og * tanhf(cn);
      if constexpr (TRAIN) {
        if (st.mask != nullptr) hn *= keep[i];
        float* grow = st.gates + (long long)rows[i] * 4 * H + u0 + j;
        grow[0] = ig;
        grow[H] = fg;
        grow[2 * H] = gg;
        grow[3 * H] = og;
        st.c[at] = cn;
      }
      h_next[at] = hn;
    }
  }
}

// q[r, q0 + col] = h2[r] . wq[:, q0 + col] + bq[q0 + col] for the rows
// [r_begin, r_end) and this block's NQ query columns, in groups of W
// (df_query_width)
template <int RT, int W>
__device__ __forceinline__ void query_phase(const float* wq_s, int NQ, const float* h2, int H2,
                                            int P, int q0, const float* bq, float* qx,
                                            int r_begin, int r_end, const Geom& geo,
                                            float* ring) {
  const int Q = NQ / W;
  const int j = threadIdx.x % Q, g = threadIdx.x / Q;
  const int rstride = geo.sub / RT;
  const bool active = g < rstride;
  for (int r = r_begin; r < r_end; r += geo.sub) {
    const int n = min(geo.sub, r_end - r);
    float acc[RT][W];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < W; ++c) acc[i][c] = 0.0f;
    staged_product<RT, W>(acc, h2, H2, nullptr, 0, r, n, Q, j, g, active, geo, ring, wq_s);
#pragma unroll
    for (int i = 0; i < RT; ++i)
      if (active && g + i * rstride < n)
#pragma unroll
        for (int c = 0; c < W; ++c)
          qx[(long long)(r + g + i * rstride) * P + q0 + j * W + c] =
              acc[i][c] + bq[q0 + j * W + c];
  }
}

// Attention, classifier and feedback for the rows of this block, `geo.att`
// of them at a time: of the rows in order of extent, longest first
// (P_PERM), positions b and 2G - 1 - b of each 2G (a snake over the blocks),
// so that every block streams about as many frames of K and V.
__device__ __forceinline__ void attend_phase(const DecodeArgs& a, const Geom& geo, int t,
                                             float* ctx_out, float* region) {
  const int P = a.P, Te = a.Te, heads = a.heads, Vp = a.Vp, B = a.B, G = gridDim.x;
  const int d = P / heads, per_row = heads * Te;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* kmat = static_cast<const float*>(a.p[P_K]);
  const float* vmat = static_cast<const float*>(a.p[P_V]);
  const float* bias = static_cast<const float*>(a.p[P_BIAS]);
  const float* wcls = static_cast<const float*>(a.p[P_WCLS]);
  const float* clsb = static_cast<const float*>(a.p[P_CLSB]);
  const float* qx = static_cast<const float*>(a.p[P_QX]);
  const int* ext_g = static_cast<const int*>(a.p[P_EXT]);
  const int* perm = static_cast<const int*>(a.p[P_PERM]);
  float* logits = static_cast<float*>(const_cast<void*>(a.p[P_LOGITS]));
  float* wgts = static_cast<float*>(const_cast<void*>(a.p[P_WGTS]));
  int* ids = static_cast<int*>(const_cast<void*>(a.p[P_IDS]));
  int* prev = static_cast<int*>(const_cast<void*>(a.p[P_PREV]));
  float* q_s = region;                          // [att][P]
  float* ctx_s = q_s + geo.att * P;             // [att][P]
  float* part_s = ctx_s + geo.att * P;          // [att][DF_WARPS][DF_VMAX]
  float* red_s = part_s + geo.att * DF_WARPS * DF_VMAX;  // the context's group sums
  float* sc_s = red_s + DF_THREADS * 4;         // [att][heads][Te]

  auto position = [&](int m) {  // this block's m-th position in the order
    return m * G + ((m & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  const int passes = (B + G - 1) / G;
  const int mine = passes - 1 + (position(passes - 1) < B ? 1 : 0);
  for (int m0 = 0; m0 < mine; m0 += geo.att) {
    const int na = min(geo.att, mine - m0);
    // the pass's rows and their extents, in registers
    int row_r[DF_ATT_ROWS], ext_r[DF_ATT_ROWS];
#pragma unroll
    for (int ra = 0; ra < DF_ATT_ROWS; ++ra) {
      row_r[ra] = ra < na ? __ldcg(perm + position(m0 + ra)) : 0;
      ext_r[ra] = ra < na ? __ldcg(ext_g + row_r[ra]) : 0;
    }
    auto pick = [&](const int (&v)[DF_ATT_ROWS], int ra) {
      int e = v[0];
#pragma unroll
      for (int q = 1; q < DF_ATT_ROWS; ++q)
        if (ra == q) e = v[q];
      return e;
    };
    auto row_of = [&](int ra) { return pick(row_r, ra); };
    auto ext_of = [&](int ra) { return pick(ext_r, ra); };
    // q (already formed by the query phase)
    for (int idx = tid; idx < na * P; idx += DF_THREADS)
      q_s[idx] = __ldcg(qx + (long long)row_of(idx / P) * P + idx % P);
    __syncthreads();
    DF_STAMP(S_Q_LOADED, t);

    // scores[ra][h][te] = (sum_i q[h, i] * k[te, h, i]) * scale + bias[te],
    // te below the row's extent: a thread takes two items at a time, items
    // and items + DF_THREADS, 16 of each one's 16-byte loads in flight
    const int items = na * per_row;
    for (int base = tid; base < items; base += 2 * DF_THREADS) {
      const float* kp[2];
      const float* qp[2];
      bool on[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int item = base + m * DF_THREADS;
        const int ra = min(item, items - 1) / per_row, h = (item % per_row) / Te, te = item % Te;
        on[m] = item < items && te < ext_of(ra);
        kp[m] = kmat + ((long long)row_of(ra) * Te + te) * P + h * d;
        qp[m] = q_s + ra * P + h * d;
      }
      if (!on[0] && !on[1]) continue;
      float s[2] = {0.0f, 0.0f};
      for (int i0 = 0; i0 < d; i0 += 64) {
        float4 kv[2][16];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int u = 0; u < 16; ++u)
            kv[m][u] = on[m] && i0 + 4 * u < d
                           ? __ldg(reinterpret_cast<const float4*>(kp[m] + i0 + 4 * u))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            if (i0 + 4 * u >= d) break;
            const float* q = qp[m] + i0 + 4 * u;
            s[m] += __fmul_rn(q[0], kv[m][u].x);
            s[m] += __fmul_rn(q[1], kv[m][u].y);
            s[m] += __fmul_rn(q[2], kv[m][u].z);
            s[m] += __fmul_rn(q[3], kv[m][u].w);
          }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int item = base + m * DF_THREADS;
        if (!on[m]) continue;
        const int ra = item / per_row, te = item % Te;
        sc_s[item] = __fadd_rn(__fmul_rn(s[m], a.scale),
                               __ldg(bias + (long long)row_of(ra) * Te + te));
      }
    }
    __syncthreads();
    DF_STAMP(S_SCORES, t);

    // softmax per row and head (a warp each) over the extent; weights out,
    // 0 past the extent
    for (int pair = warp; pair < na * heads; pair += DF_WARPS) {
      const int ra = pair / heads, h = pair % heads, ext = ext_of(ra);
      float* sh = sc_s + ra * per_row + h * Te;
      float* wrow = wgts + ((long long)t * B + row_of(ra)) * per_row + h * Te;
      float mx = -CUDART_INF_F;
      for (int te = lane; te < ext; te += 32) mx = fmaxf(mx, sh[te]);
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      float sum = 0.0f;
      for (int te = lane; te < ext; te += 32) {
        const float e = expf(sh[te] - mx);
        sh[te] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      for (int te = lane; te < Te; te += 32) {
        const float w = te < ext ? sh[te] / sum : 0.0f;
        if (te < ext) sh[te] = w;
        wrow[te] = w;
      }
    }
    __syncthreads();
    DF_STAMP(S_SOFTMAX, t);

    // context[ra][p] = sum_te w[ra][h(p)][te] * v[te, p]: thread (ra, group
    // g, slice s) sums frames g, g + groups, ... below the extent of the
    // four columns of slice s (one head's: d % 4 == 0); the groups' sums
    // meet in shared memory
    const int slices = P / 4, groups = DF_THREADS / (na * slices);
    {
      const int ra = tid / (groups * slices), rem = tid % (groups * slices);
      const int gi = rem / slices, p0 = (rem % slices) * 4;
      if (ra < na) {
        const int ext = ext_of(ra);
        const float* wh = sc_s + ra * per_row + (p0 / d) * Te;
        const float* vrow = vmat + (long long)row_of(ra) * Te * P + p0;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        // sixteen frames' loads in flight a thread (a frame past the extent
        // adds 0 * 0)
        for (int base = gi; base < ext; base += 16 * groups) {
          float4 vv[16];
          float w[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            const int te = base + u * groups;
            const bool in = te < ext;
            vv[u] = in ? __ldg(reinterpret_cast<const float4*>(vrow + (long long)te * P))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            w[u] = in ? wh[te] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            acc[0] += __fmul_rn(w[u], vv[u].x);
            acc[1] += __fmul_rn(w[u], vv[u].y);
            acc[2] += __fmul_rn(w[u], vv[u].z);
            acc[3] += __fmul_rn(w[u], vv[u].w);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) red_s[(ra * groups + gi) * P + p0 + jj] = acc[jj];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < na * P; idx += DF_THREADS) {
      const int ra = idx / P, p = idx % P;
      float acc = 0.0f;
      for (int k = 0; k < groups; ++k) acc += red_s[(ra * groups + k) * P + p];
      ctx_s[idx] = acc;
      ctx_out[(long long)row_of(ra) * P + p] = acc;
    }
    __syncthreads();
    DF_STAMP(S_CONTEXT, t);

    // tied classifier over cat(q, ctx): warp w sums its slice of the 2P
    // inputs for vocabulary entry `lane`, every row of the pass on each
    // weight it loads
    {
      const int span = 2 * P / DF_WARPS;
      float part[DF_ATT_ROWS] = {};
      if (lane < Vp)
        for (int e = warp * span; e < (warp + 1) * span; ++e) {
          const float w = __ldg(wcls + (long long)e * Vp + lane);
          const float* xs = e < P ? q_s + e : ctx_s + (e - P);
#pragma unroll
          for (int ra = 0; ra < DF_ATT_ROWS; ++ra)
            if (ra < na) part[ra] = fmaf(xs[ra * P], w, part[ra]);
        }
#pragma unroll
      for (int ra = 0; ra < DF_ATT_ROWS; ++ra)
        if (ra < na) part_s[(ra * DF_WARPS + warp) * DF_VMAX + lane] = part[ra];
    }
    __syncthreads();
    if (warp < na) {
      const int ra = warp, r = row_of(ra);
      float logit = -CUDART_INF_F;
      if (lane < Vp) {
        float s = 0.0f;
        for (int w = 0; w < DF_WARPS; ++w) s += part_s[(ra * DF_WARPS + w) * DF_VMAX + lane];
        logit = s + __ldg(clsb + lane);
        logits[((long long)t * B + r) * Vp + lane] = logit;
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
      if (lane == 0) {
        ids[(long long)t * B + r] = idx;
        prev[r] = idx;
      }
    }
    __syncthreads();  // the pass's shared buffers are reused by the next pass
    DF_STAMP(S_CLASSIFIER, t);
  }
}

template <bool TRAIN>
__global__ void __launch_bounds__(DF_THREADS, 1) speller_decode_kernel(DecodeArgs a, Geom geo) {
  extern __shared__ __align__(16) float smem[];
  const int P = a.P, H1 = a.H1, H2 = a.H2, B = a.B, Te = a.Te, G = gridDim.x;
  const int cgi = blockIdx.x % geo.cg, rgi = blockIdx.x / geo.cg;
  const int U1 = H1 / geo.cg, U2 = H2 / geo.cg, NQ = P / geo.cg;
  const int K1 = P + H1, K2 = H1 + H2;
  const int u01 = cgi * U1, u02 = cgi * U2, q0 = cgi * NQ;
  const int r_begin = min(B, rgi * geo.rows), r_end = min(B, r_begin + geo.rows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* w1_s = smem;                 // [K1][unit][gate]
  float* w2_s = w1_s + K1 * U1 * 4;   // [K2][unit][gate]
  float* wq_s = w2_s + K2 * U2 * 4;   // [H2][column]
  float* region = wq_s + H2 * NQ;

  const float* wc1 = static_cast<const float*>(a.p[P_WC1]);
  const float* whh1 = static_cast<const float*>(a.p[P_WHH1]);
  const float* wih2 = static_cast<const float*>(a.p[P_WIH2]);
  const float* whh2 = static_cast<const float*>(a.p[P_WHH2]);
  const float* wq = static_cast<const float*>(a.p[P_WQ]);
  // this block's weight columns, for the whole launch
  for (int idx = tid; idx < K1 * U1 * 4; idx += DF_THREADS) {
    const int k = idx / (U1 * 4), u = (idx / 4) % U1, gate = idx % 4;
    const long long col = gate * H1 + u01 + u;
    w1_s[idx] = k < P ? wc1[(long long)k * 4 * H1 + col] : whh1[(long long)(k - P) * 4 * H1 + col];
  }
  for (int idx = tid; idx < K2 * U2 * 4; idx += DF_THREADS) {
    const int k = idx / (U2 * 4), u = (idx / 4) % U2, gate = idx % 4;
    const long long col = gate * H2 + u02 + u;
    w2_s[idx] =
        k < H1 ? wih2[(long long)k * 4 * H2 + col] : whh2[(long long)(k - H1) * 4 * H2 + col];
  }
  for (int idx = tid; idx < H2 * NQ; idx += DF_THREADS)
    wq_s[idx] = wq[(long long)(idx / NQ) * P + q0 + idx % NQ];

  float* h1x = static_cast<float*>(const_cast<void*>(a.p[P_H1X]));
  float* h2x = static_cast<float*>(const_cast<void*>(a.p[P_H2X]));
  float* ctxx = static_cast<float*>(const_cast<void*>(a.p[P_CTXX]));
  float* qx = static_cast<float*>(const_cast<void*>(a.p[P_QX]));
  float* c1 = static_cast<float*>(const_cast<void*>(a.p[P_C1]));
  float* c2 = static_cast<float*>(const_cast<void*>(a.p[P_C2]));
  int* prev = static_cast<int*>(const_cast<void*>(a.p[P_PREV]));
  int* ext = static_cast<int*>(const_cast<void*>(a.p[P_EXT]));

  // the t = -1 state: h and ctx as given, c as fp32, <sos> fed back. The
  // training form reads h and ctx of t = -1 where they are, and afterwards
  // from its h1d, h2d and context streams. And each row's extent: one past
  // its last frame whose bias is above DF_MASKED (Te if none is), a warp a
  // row.
  const float* h10 = static_cast<const float*>(a.p[P_H10]);
  const float* h20 = static_cast<const float*>(a.p[P_H20]);
  const float* ctx0 = static_cast<const float*>(a.p[P_CTX0]);
  {
    const float* c10 = static_cast<const float*>(a.p[P_C10]);
    const float* c20 = static_cast<const float*>(a.p[P_C20]);
    const long long gt = (long long)blockIdx.x * DF_THREADS + tid;
    const long long stride = (long long)G * DF_THREADS;
    for (long long i = gt; i < (long long)B * H1; i += stride) {
      if constexpr (!TRAIN) h1x[i] = h10[i];
      c1[i] = c10[i];
    }
    for (long long i = gt; i < (long long)B * H2; i += stride) {
      if constexpr (!TRAIN) h2x[i] = h20[i];
      c2[i] = c20[i];
    }
    if constexpr (!TRAIN)
      for (long long i = gt; i < (long long)B * P; i += stride) ctxx[i] = ctx0[i];
    for (long long i = gt; i < B; i += stride) prev[i] = a.sos;
    const float* bias = static_cast<const float*>(a.p[P_BIAS]);
    for (int r = blockIdx.x * DF_WARPS + warp; r < B; r += G * DF_WARPS) {
      int last = -1;
      for (int te = lane; te < Te; te += 32)
        if (__ldg(bias + (long long)r * Te + te) > DF_MASKED) last = te;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) last = max(last, __shfl_xor_sync(FULL, last, o));
      if (lane == 0) ext[r] = last < 0 ? Te : last + 1;
    }
  }
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  {
    // the rows in order of extent, longest first (ties by row): row r goes
    // to the position of its rank
    int* perm = static_cast<int*>(const_cast<void*>(a.p[P_PERM]));
    for (int r = blockIdx.x * DF_THREADS + tid; r < B; r += G * DF_THREADS) {
      const int e = __ldcg(ext + r);
      int rank = 0;
#pragma unroll 8
      for (int q = 0; q < B; ++q) {
        const int eq = __ldcg(ext + q);
        rank += eq > e || (eq == e && q < r);
      }
      perm[rank] = r;
    }
  }
  grid.sync();

  const float* embw1 = static_cast<const float*>(a.p[P_EMBW1]);
  const float* b2 = static_cast<const float*>(a.p[P_B2]);
  const float* bq = static_cast<const float*>(a.p[P_BQ]);
  const int* forced = static_cast<const int*>(a.p[P_FORCED]);
  const float* m1 = static_cast<const float*>(a.p[P_M1]);
  const float* m2 = static_cast<const float*>(a.p[P_M2]);
  int* sel = static_cast<int*>(const_cast<void*>(a.p[P_SEL]));
  float* gates1 = static_cast<float*>(const_cast<void*>(a.p[P_GATES1]));
  float* c1r = static_cast<float*>(const_cast<void*>(a.p[P_C1R]));
  float* h1d = static_cast<float*>(const_cast<void*>(a.p[P_H1D]));
  float* gates2 = static_cast<float*>(const_cast<void*>(a.p[P_GATES2]));
  float* c2r = static_cast<float*>(const_cast<void*>(a.p[P_C2R]));
  float* h2d = static_cast<float*>(const_cast<void*>(a.p[P_H2D]));
  float* ctxr = static_cast<float*>(const_cast<void*>(a.p[P_CTXR]));
  for (int t = 0; t < a.T; ++t) {
    const float *h1_prev, *h2_prev, *ctx_prev;
    float *h1_next, *h2_next, *ctx_next;
    CellStreams st1{nullptr, nullptr, nullptr, nullptr}, st2{nullptr, nullptr, nullptr, nullptr};
    if constexpr (TRAIN) {
      const long long row = (long long)t * B;  // this step's rows of a (T, B, .) stream
      h1_prev = t == 0 ? h10 : h1d + (row - B) * H1;
      h1_next = h1d + row * H1;
      h2_prev = t == 0 ? h20 : h2d + (row - B) * H2;
      h2_next = h2d + row * H2;
      ctx_prev = t == 0 ? ctx0 : ctxr + (row - B) * P;
      ctx_next = ctxr + row * P;
      st1 = {m1 != nullptr ? m1 + row * H1 : nullptr, gates1 + row * 4 * H1, c1r + row * H1,
             sel + row};
      st2 = {m2 != nullptr ? m2 + row * H2 : nullptr, gates2 + row * 4 * H2, c2r + row * H2,
             nullptr};
    } else {
      h1_prev = h1x + (long long)(t & 1) * B * H1;
      h1_next = h1x + (long long)((t + 1) & 1) * B * H1;
      h2_prev = h2x + (long long)(t & 1) * B * H2;
      h2_next = h2x + (long long)((t + 1) & 1) * B * H2;
      ctx_prev = ctxx;
      ctx_next = ctxx;
    }
    const int* forced_t = forced != nullptr ? forced + (long long)t * B : nullptr;

    DF_STAMP(S_STEP, t);
    with_tile_rows(geo.sub, U1, [&](auto rt) {
      cell_phase<TRAIN, decltype(rt)::value>(w1_s, U1, ctx_prev, P, h1_prev, H1, H1, u01, embw1,
                                             forced_t, prev, c1, h1_next, r_begin, r_end, geo,
                                             region, st1, cgi == 0);
    });
    DF_STAMP(S_CELL1, t);
    grid.sync();
    DF_STAMP(S_CELL1_SYNCED, t);
    with_tile_rows(geo.sub, U2, [&](auto rt) {
      cell_phase<TRAIN, decltype(rt)::value>(w2_s, U2, h1_next, H1, h2_prev, H2, H2, u02, b2,
                                             nullptr, nullptr, c2, h2_next, r_begin, r_end, geo,
                                             region, st2, false);
    });
    DF_STAMP(S_CELL2, t);
    grid.sync();
    DF_STAMP(S_CELL2_SYNCED, t);
    auto query = [&](auto width) {
      constexpr int W = decltype(width)::value;
      with_tile_rows(geo.sub, NQ / W, [&](auto rt) {
        query_phase<decltype(rt)::value, W>(wq_s, NQ, h2_next, H2, P, q0, bq, qx, r_begin,
                                            r_end, geo, region);
      });
    };
    switch (df_query_width(NQ)) {
      case 4: query(Count<4>()); break;
      case 2: query(Count<2>()); break;
      default: query(Count<1>()); break;
    }
    DF_STAMP(S_QUERY, t);
    grid.sync();
    DF_STAMP(S_QUERY_SYNCED, t);
    attend_phase(a, geo, t, ctx_next, region);
    DF_STAMP(S_ATTEND, t);
    grid.sync();
  }
}

// The geometry this body takes (ops/speller_cuda.py::plan_decode_f32 checks
// it first, with the limits below): CG dividing H1, H2 and P; sub rows a
// multiple of DF_RT, every product's tiles of DF_RT rows within DF_THREADS
// threads (sub / DF_RT x groups; df_tile_rows takes fewer rows a thread only
// below DF_BUSY threads); att rows of P / 4 slices at most DF_THREADS; Vp <=
// DF_VMAX; P, H1 and H2 multiples of 8 and the head width of 4.
static bool geometry_ok(const DecodeArgs& a, const Geom& g) {
  if (g.cg < 1 || g.rg < 1 || g.cg * g.rg > DF_MAX_GRID || g.rows < 1 || g.sub < DF_RT ||
      g.sub % DF_RT || g.stages < 1 || g.stages > DF_MAX_STAGES || g.att < 1 ||
      g.att > DF_ATT_ROWS)
    return false;
  if (a.P % 8 || a.H1 % 8 || a.H2 % 8 || a.P % g.cg || a.H1 % g.cg || a.H2 % g.cg) return false;
  if (a.heads < 1 || a.P % a.heads || (a.P / a.heads) % 4 || a.Vp > DF_VMAX) return false;
  const int NQ = a.P / g.cg;
  const int groups[3] = {a.H1 / g.cg, a.H2 / g.cg, NQ / df_query_width(NQ)};
  for (int i = 0; i < 3; ++i)
    if (g.sub / DF_RT * groups[i] > DF_THREADS) return false;
  return g.att * (a.P / 4) <= DF_THREADS;
}

template <bool TRAIN>
static cudaError_t launch(const DecodeArgs& a, const Geom& geo, cudaStream_t stream) {
  auto kernel = speller_decode_kernel<TRAIN>;
  const size_t smem =
      df_smem_bytes(a.Te, a.P, a.heads, a.H1, a.H2, geo.cg, geo.sub, geo.stages, geo.att);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  DecodeArgs args = a;
  Geom g = geo;
  void* params[] = {&args, &g};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(geo.cg * geo.rg),
                                    dim3(DF_THREADS), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The constants the plan (ops/speller_cuda.py, F32_LIMITS) mirrors, the
// shared memory a block of `device` may opt into and its SMs: out =
// {DF_MAX_GRID, DF_THREADS, DF_VMAX, DF_RT, DF_KC, DF_PAD, DF_MAX_STAGES,
// DF_ATT_ROWS, optin, sms}. Returns a cudaError_t (0 on success).
extern "C" int speller_decode_limits(int device, long long* out) {
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long vals[] = {DF_MAX_GRID, DF_THREADS, DF_VMAX,       DF_RT, DF_KC,
                            DF_PAD,      DF_MAX_STAGES, DF_ATT_ROWS, optin, sms};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return (int)err;
}

// the shared memory a block of the given geometry uses (df_smem_bytes), for
// a card test of the plan's formula
extern "C" size_t speller_decode_smem_bytes(int Te, int P, int heads, int H1, int H2, int cgroups,
                                            int sub, int stages, int att) {
  return df_smem_bytes(Te, P, heads, H1, H2, cgroups, sub, stages, att);
}

// dtype: 0 = float32 (the only one this source instantiates; bfloat16 is
// speller_decode_tc.cu's). geom: N_GEOM ints in enum GeomSlot order (the
// plan's). ptrs: N_PTRS device pointers in enum Ptr order (P_FORCED may be
// null; with train == 0 the slots P_M1 .. P_CTXR are not read; with train
// != 0 P_M1 and P_M2 may be null, and P_H1X, P_H2X and P_CTXX are not
// touched); dims: N_DIMS ints in enum Dim order. Returns a cudaError_t (0 on
// success).
extern "C" int speller_decode_launch(int dtype, int train, const int* geom,
                                     const void* const* ptrs, const int* dims, float scale,
                                     void* stream) {
  DecodeArgs a;
  for (int i = 0; i < N_PTRS; ++i) a.p[i] = ptrs[i];
  a.B = dims[D_B];
  a.Te = dims[D_TE];
  a.T = dims[D_T];
  a.P = dims[D_P];
  a.heads = dims[D_HEADS];
  a.H1 = dims[D_H1];
  a.H2 = dims[D_H2];
  a.Vp = dims[D_VP];
  a.sos = dims[D_SOS];
  a.scale = scale;
  const Geom g{geom[G_CG], geom[G_RG], geom[G_ROWS], geom[G_SUB], geom[G_STAGES], geom[G_ATT]};
  if (dtype != 0 || !geometry_ok(a, g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return train ? launch<true>(a, g, s) : launch<false>(a, g, s);
}
