// Adjoint of the fused speller decode (speller_decode.cu, TRAIN = true) for
// Hopper (sm_90a), in float32: one cooperative launch walks every step of the
// decode backwards for the whole batch. bfloat16 runs on speller_bwd_tc.cu
// (the three products on tensor cores, counters in place of the barriers).
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/speller_pallas.py):
//   _decode_bwd_kernel (:223), launched by _bwd_chunk (:554): TPU kernel #9.
//
// What it computes. Time runs down from T - 1 to 0. With the forward's saved
// streams (both cells' activated gates and c, the attention weights w, the
// dropout masks m1, m2), the upstream cotangents of q and of the context
// through the tied classifier (dqup, dctxup) and, where the caller has one,
// of the weights (dwup), and the fp32 carries dh1, dc1, dh2, dc2, dctx (zero
// at t = T - 1), a step is four phases, each needing the whole previous one:
//   (a) per batch row and head: d_ctx = dctx + dctxup[t];
//       dw = d_ctx . V (+ dwup[t]);  dsc = w * (dw - sum(dw * w));
//       dq_att = (dsc * scale) . K;  d_q = dq_att + dqup[t];
//   (b) d_h2d = dh2 + d_q @ wq^T; times m2[t]; cell 2's gate adjoint
//       with c2[t] and c2[t - 1] (c20 at t = 0) -> dpre2; dc2 = dc2_tot * f2;
//   (c) d_h1d = dh1 + dpre2 @ wih2^T and dh2 = dpre2 @ whh2^T;
//       d_h1d times m1[t]; cell 1's gate adjoint -> dpre1; dc1 = dc1_tot * f1;
//   (d) dh1 = dpre1 @ whh1^T and dctx = dpre1 @ wc1^T.
// Streams out, in float32: dpre1 (T, B, 4H1), dpre2 (T, B, 4H2), dq
// and dctxtot (= d_ctx) (T, B, P), dsc (T, B, heads, Te). After t = 0 the
// carries are the outputs dh10, dc10, dh20, dc20, dctx0 in fp32. There is no
// length mask: every step runs for every row, as in the forward.
//
// Numerics follow the Pallas kernel (and ops/speller_cuda.py's plain
// version) in float32, where its roundings of the dot operands to the weight
// dtype are identities: every product, sum, gate adjoint and carry is fp32.
//
// What bounds it: as the forward, 4 x T dependent phases. Phase (d) reads all
// of dpre1[t] (B x 4H1 elements: 1 MB at B = 128, H1 = 512) in every
// block, phase (c) all of dpre2[t]: a step moves about three times the
// forward's exchange bytes through L2 for about the same FMAs, so it is bound
// by the latency and L2 bandwidth of those reads plus four grid barriers
// (PERF.md has the measured times).
//
// Design. The forward's persistent grid: G blocks (G = 128 at base- and
// scaled-LAS), block g owns U1 = H1 / G units of cell 1, U2 = H2 / G of cell 2
// and NQ = P / G context columns, and keeps in shared memory, for the whole
// launch, the ROWS of the weights those need: for (d) rows
// of whh1 (its units) and of wc1 (its context columns) over a reduction of
// 4H1; for (c) rows of wih2 (its cell-1 units) and whh2 (its cell-2 units)
// over 4H2; for (b) rows of wq over P. A product with W^T is then the
// forward's dot: a warp takes two batch rows at a time, its lanes split the
// row's vector (16-byte loads from L2), and a transposing butterfly leaves
// each column's sum on its own lanes. The whole batch runs in one launch, not
// in row chunks: the weights a block holds serve every row, a chunk would pay
// the 4 x T barriers again, and the time measured at B = 128 is below four
// times that at B = 32 (PERF.md). The dq, dpre2 and dpre1 output streams
// double as the exchange buffers between blocks. The lane that applies a
// unit's gate adjoint owns that (row, unit)'s dh and dc carries, which live in
// the output buffers dh10 ... dc20 and are touched by that thread only; dctx
// crosses blocks through the dctx0 buffer. Phase (a) gives block r batch row
// r (r += G): thread per (head, frame) for dw, a warp per head for the softmax
// adjoint, thread per (frame group, 16-byte column slice) for dq_att with the
// groups summed in shared memory. K and V stream from global memory each step.
// c[t - 1] is indexed in the saved stream; no shifted copy is made. Plain FMA
// on the CUDA cores; tensor cores are later work.

#include <cooperative_groups.h>

#include "speller_common.cuh"

namespace cg = cooperative_groups;

// pointer slots of the launch (the order of ops/speller_cuda.py's list)
enum Ptr {
  P_K, P_V, P_WC1, P_WHH1, P_WIH2, P_WHH2, P_WQ, P_C10, P_C20, P_GATES1, P_C1, P_GATES2, P_C2,
  P_WGTS, P_M1, P_M2, P_DQUP, P_DCTXUP, P_DWUP,
  // outputs
  P_DPRE1, P_DPRE2, P_DQ, P_DCTXTOT, P_DSC, P_DH1, P_DC1, P_DH2, P_DC2, P_DCTX, N_PTRS
};
// int slots
enum Dim { D_B, D_TE, D_T, D_P, D_HEADS, D_H1, D_H2, N_DIMS };

struct BwdArgs {
  const void* p[N_PTRS];
  int B, Te, T, P, heads, H1, H2;
  float scale;
};

// What the gate adjoint of one (row, unit) reads at one step.
struct Saved {
  float gi, gf, gg, go, c, c_prev, keep, dh, dc;
};

// gates_t (B, 4H), c_t and c_prev_t (B, H), mask_t (B, H) or null: this step's
// rows of the saved streams; dh_c, dc_c (B, H) fp32: the carries, zero at the
// first step of the walk.
__device__ __forceinline__ Saved load_saved(const float* gates_t, const float* c_t,
                                            const float* c_prev_t, const float* mask_t,
                                            const float* dh_c, const float* dc_c, bool first,
                                            int row, int H, int unit) {
  Saved s;
  const float* grow = gates_t + (long long)row * 4 * H + unit;
  const long long off = (long long)row * H + unit;
  s.gi = ld_nc(grow);
  s.gf = ld_nc(grow + H);
  s.gg = ld_nc(grow + 2 * H);
  s.go = ld_nc(grow + 3 * H);
  s.c = ld_nc(c_t + off);
  s.c_prev = ld_nc(c_prev_t + off);
  s.keep = mask_t != nullptr ? ld_nc(mask_t + off) : 1.0f;
  s.dh = first ? 0.0f : dh_c[off];
  s.dc = first ? 0.0f : dc_c[off];
  return s;
}

// The gate adjoint of one (row, unit): d_hd is the cotangent of the dropped
// output; writes the four dpre and the dc carry.
__device__ __forceinline__ void cell_adjoint(const Saved& s, float d_hd, bool masked, float* dpre_t,
                                             float* dc_c, int row, int H, int unit) {
  const float d_hn = masked ? d_hd * s.keep : d_hd;
  const float tanh_c = tanhf(s.c);
  const float dc_tot = s.dc + d_hn * s.go * (1.0f - tanh_c * tanh_c);
  float* prow = dpre_t + (long long)row * 4 * H + unit;
  prow[0] = dc_tot * s.gg * s.gi * (1.0f - s.gi);
  prow[H] = dc_tot * s.c_prev * s.gf * (1.0f - s.gf);
  prow[2 * H] = dc_tot * s.gi * (1.0f - s.gg * s.gg);
  prow[3 * H] = d_hn * tanh_c * s.go * (1.0f - s.go);
  dc_c[(long long)row * H + unit] = dc_tot * s.gf;
}

// What a cell's adjoint reads and writes at one step.
struct CellStep {
  const float* gates_t;
  const float* c_t;
  const float* c_prev_t;
  const float* mask_t;
  float* dh_c;
  float* dc_c;
  float* dpre_t;
  int H, u0;
  bool first;
};

// Phase (b): d_h2d[r, u] = dh2[r, u] + x[r] . w_s[u] over this block's NA
// units of the cell, then the cell's gate adjoint. x (B, K) is dq[t].
template <int NA>
__device__ __forceinline__ void adjoint_b(const float* w_s, const float* x, int K, int B,
                                          const CellStep& cell) {
  constexpr int SA = 5 - log2i(NA);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp; r0 < B; r0 += ROWS * NWARPS) {
    int rows[ROWS];
    bool live[ROWS];
    warp_rows(r0, B, rows, live);
    Saved sv[ROWS];
    if (lane < NA) {  // the saved values load before the dot, behind its latency
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        sv[i] = load_saved(cell.gates_t, cell.c_t, cell.c_prev_t, cell.mask_t, cell.dh_c,
                           cell.dc_c, cell.first, rows[i], cell.H, cell.u0 + lane);
    }
    float acc[ROWS][NA];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[i][j] = 0.0f;
    dot_rows<float, NA>(acc, x, K, rows, w_s, K, 0, lane);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      halve<NA, 16>(acc[i], lane);
      const float dot = __shfl_sync(FULL, acc[i][0], (lane % NA) << SA);
      if (lane < NA && live[i])
        cell_adjoint(sv[i], sv[i].dh + dot, cell.mask_t != nullptr, cell.dpre_t, cell.dc_c,
                     rows[i], cell.H, cell.u0 + lane);
    }
  }
}

// Phases (c) and (d): one pass over x (B, K) against NA + NB weight rows.
// CELL (phase (c), x = dpre2[t]): the first NA sums are d_h1d - dh1 of this
// block's cell-1 units, whose gate adjoint follows; the last NB are the new dh2
// of its cell-2 units, written to out_b (B, Hb) at column b0. Not CELL (phase
// (d), x = dpre1[t]): the first NA sums are the new dh1 of its cell-1 units,
// written to cell.dh_c; the last NB the new dctx of its context columns,
// written to out_b.
template <int NA, int NB, bool CELL>
__device__ __forceinline__ void adjoint_cd(const float* w_s, const float* x, int K, int B,
                                           const CellStep& cell, float* out_b, int Hb, int b0) {
  constexpr int SA = 5 - log2i(NA), SB = 5 - log2i(NB);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp; r0 < B; r0 += ROWS * NWARPS) {
    int rows[ROWS];
    bool live[ROWS];
    warp_rows(r0, B, rows, live);
    Saved sv[ROWS];
    if constexpr (CELL) {
      if (lane < NA) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          sv[i] = load_saved(cell.gates_t, cell.c_t, cell.c_prev_t, cell.mask_t, cell.dh_c,
                             cell.dc_c, cell.first, rows[i], cell.H, cell.u0 + lane);
      }
    }
    float acc[ROWS][NA + NB];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < NA + NB; ++j) acc[i][j] = 0.0f;
    dot_rows<float, NA + NB>(acc, x, K, rows, w_s, K, 0, lane);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      halve<NA, 16>(acc[i], lane);
      halve<NB, 16>(acc[i] + NA, lane);
      const float dot_a = __shfl_sync(FULL, acc[i][0], (lane % NA) << SA);
      const float dot_b = __shfl_sync(FULL, acc[i][NA], (lane % NB) << SB);
      if (lane < NA && live[i]) {
        if constexpr (CELL)
          cell_adjoint(sv[i], sv[i].dh + dot_a, cell.mask_t != nullptr, cell.dpre_t,
                       cell.dc_c, rows[i], cell.H, cell.u0 + lane);
        else
          cell.dh_c[(long long)rows[i] * cell.H + cell.u0 + lane] = dot_a;
      }
      if (lane < NB && live[i]) out_b[(long long)rows[i] * Hb + b0 + lane] = dot_b;
    }
  }
}

// Phase (a): the attention and softmax adjoint of the rows of this block.
__device__ __forceinline__ void attend_adjoint(const BwdArgs& a, int t, bool first, float* dch_s,
                                               float* red_s, float* dw_s, float* w_s) {
  constexpr int VEC = 16 / sizeof(float);
  const int P = a.P, Te = a.Te, heads = a.heads, B = a.B;
  const int d = P / heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* kmat = static_cast<const float*>(a.p[P_K]);
  const float* vmat = static_cast<const float*>(a.p[P_V]);
  const float* wgts = static_cast<const float*>(a.p[P_WGTS]);
  const float* dqup = static_cast<const float*>(a.p[P_DQUP]);
  const float* dctxup = static_cast<const float*>(a.p[P_DCTXUP]);
  const float* dwup = static_cast<const float*>(a.p[P_DWUP]);
  const float* dctx_c = static_cast<const float*>(a.p[P_DCTX]);
  float* dq = static_cast<float*>(const_cast<void*>(a.p[P_DQ]));
  float* dctxtot = static_cast<float*>(const_cast<void*>(a.p[P_DCTXTOT]));
  float* dsc_out = static_cast<float*>(const_cast<void*>(a.p[P_DSC]));

  for (int r = blockIdx.x; r < B; r += gridDim.x) {
    const long long row = (long long)t * B + r;
    // d_ctx = dctx + dctxup[t]: stored, and kept for the product with V
    for (int p = threadIdx.x; p < P; p += NTHREADS) {
      const float carry = first ? 0.0f : __ldcg(dctx_c + (long long)r * P + p);
      const float d_ctx = carry + ld_nc(dctxup + row * P + p);
      dctxtot[row * P + p] = d_ctx;
      dch_s[p] = d_ctx;
    }
    __syncthreads();

    // dw[h][te] = sum_i d_ctx[h, i] * v[te, h, i] (+ dwup); w beside it
    const float* vrow = vmat + (long long)r * Te * P;
    for (int item = threadIdx.x; item < heads * Te; item += NTHREADS) {
      const int h = item / Te, te = item % Te;
      const float* vp = vrow + (long long)te * P + h * d;
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
      w_s[item] = ld_nc(wgts + row * heads * Te + item);
    }
    __syncthreads();

    // softmax adjoint per head (warp h): dsc = w * (dw - sum(dw * w)); dsc out,
    // dsc * scale kept for the product with K
    for (int h = warp; h < heads; h += NWARPS) {
      float* dwh = dw_s + h * Te;
      const float* wh = w_s + h * Te;
      float sum = 0.0f;
      for (int te = lane; te < Te; te += 32) sum += dwh[te] * wh[te];
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      for (int te = lane; te < Te; te += 32) {
        const float dsc = wh[te] * (dwh[te] - sum);
        dsc_out[row * heads * Te + h * Te + te] = dsc;
        dwh[te] = dsc * a.scale;
      }
    }
    __syncthreads();

    // dq_att[p] = sum_te dsc_scaled[h(p)][te] * k[te, p]: thread (group g,
    // slice s) sums frames g, g + groups, ... of the VEC columns of slice s
    // (one head's: d % VEC == 0); the groups' sums meet in shared memory
    const float* krow = kmat + (long long)r * Te * P;
    const int slices = P / VEC, groups = NTHREADS / slices;
    const int g = threadIdx.x / slices, p0 = (threadIdx.x % slices) * VEC;
    if (g < groups) {
      const float* dh = dw_s + (p0 / d) * Te;
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
#pragma unroll 4
      for (int te = g; te < Te; te += groups) {
        float kv[VEC];
        load16_nc(krow + (long long)te * P + p0, kv);
        const float ds = dh[te];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += __fmul_rn(ds, kv[j]);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) red_s[g * P + p0 + j] = acc[j];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < P; p += NTHREADS) {
      float acc = 0.0f;
      for (int k = 0; k < groups; ++k) acc += red_s[k * P + p];
      dq[row * P + p] = acc + ld_nc(dqup + row * P + p);
    }
    __syncthreads();  // the row's shared buffers are reused by the next row
  }
}

// bytes of dynamic shared memory: the three weight slices, then d_ctx,
// dq_att's group sums, and dw and w of every head
static size_t smem_bytes(int grid, int Te, int P, int heads, int H1, int H2) {
  const size_t u1 = H1 / grid, u2 = H2 / grid, nq = P / grid;
  const size_t weights = ((u1 + nq) * 4 * H1 + (u1 + u2) * 4 * H2 + u2 * P) * sizeof(float);
  const size_t floats = (size_t)P + NTHREADS * 4 + 2 * (size_t)heads * Te;
  return align16(weights) + floats * sizeof(float);
}

__global__ void __launch_bounds__(NTHREADS, 1) speller_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P, H1 = a.H1, H2 = a.H2, B = a.B, G = gridDim.x;
  const int U1 = H1 / G, U2 = H2 / G, NQ = P / G;
  const int KD = 4 * H1, KC = 4 * H2;
  const int u01 = blockIdx.x * U1, u02 = blockIdx.x * U2, q0 = blockIdx.x * NQ;

  float* wd_s = reinterpret_cast<float*>(smem_raw);  // (d): rows of whh1, then of wc1
  float* wc_s = wd_s + (U1 + NQ) * KD;           // (c): rows of wih2, then of whh2
  float* wb_s = wc_s + (U1 + U2) * KC;           // (b): rows of wq
  float* dch_s = reinterpret_cast<float*>(
      smem_raw +
      align16(((size_t)(U1 + NQ) * KD + (size_t)(U1 + U2) * KC + (size_t)U2 * P) * sizeof(float)));
  float* red_s = dch_s + P;
  float* dw_s = red_s + NTHREADS * (16 / sizeof(float));
  float* w_s = dw_s + a.heads * a.Te;

  {
    const float* wc1 = static_cast<const float*>(a.p[P_WC1]);
    const float* whh1 = static_cast<const float*>(a.p[P_WHH1]);
    const float* wih2 = static_cast<const float*>(a.p[P_WIH2]);
    const float* whh2 = static_cast<const float*>(a.p[P_WHH2]);
    const float* wq = static_cast<const float*>(a.p[P_WQ]);
    // this block's weight rows, [row][k], for the whole launch
    for (int idx = threadIdx.x; idx < (U1 + NQ) * KD; idx += NTHREADS) {
      const int c = idx / KD, k = idx % KD;
      wd_s[idx] = c < U1 ? whh1[(long long)(u01 + c) * KD + k] : wc1[(long long)(q0 + c - U1) * KD + k];
    }
    for (int idx = threadIdx.x; idx < (U1 + U2) * KC; idx += NTHREADS) {
      const int c = idx / KC, k = idx % KC;
      wc_s[idx] = c < U1 ? wih2[(long long)(u01 + c) * KC + k] : whh2[(long long)(u02 + c - U1) * KC + k];
    }
    for (int idx = threadIdx.x; idx < U2 * P; idx += NTHREADS)
      wb_s[idx] = wq[(long long)(u02 + idx / P) * P + idx % P];
  }
  __syncthreads();

  const float* c10 = static_cast<const float*>(a.p[P_C10]);
  const float* c20 = static_cast<const float*>(a.p[P_C20]);
  const float* gates1 = static_cast<const float*>(a.p[P_GATES1]);
  const float* c1 = static_cast<const float*>(a.p[P_C1]);
  const float* gates2 = static_cast<const float*>(a.p[P_GATES2]);
  const float* c2 = static_cast<const float*>(a.p[P_C2]);
  const float* m1 = static_cast<const float*>(a.p[P_M1]);
  const float* m2 = static_cast<const float*>(a.p[P_M2]);
  float* dpre1 = static_cast<float*>(const_cast<void*>(a.p[P_DPRE1]));
  float* dpre2 = static_cast<float*>(const_cast<void*>(a.p[P_DPRE2]));
  const float* dq = static_cast<const float*>(a.p[P_DQ]);
  float* dh1_c = static_cast<float*>(const_cast<void*>(a.p[P_DH1]));
  float* dc1_c = static_cast<float*>(const_cast<void*>(a.p[P_DC1]));
  float* dh2_c = static_cast<float*>(const_cast<void*>(a.p[P_DH2]));
  float* dc2_c = static_cast<float*>(const_cast<void*>(a.p[P_DC2]));
  float* dctx_c = static_cast<float*>(const_cast<void*>(a.p[P_DCTX]));

  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < a.T; ++s) {
    const int t = a.T - 1 - s;
    const bool first = s == 0;
    const long long row = (long long)t * B;  // this step's rows of a (T, B, .) stream

    attend_adjoint(a, t, first, dch_s, red_s, dw_s, w_s);
    grid.sync();

    const CellStep cell2{gates2 + row * 4 * H2,
                            c2 + row * H2,
                            t == 0 ? c20 : c2 + (row - B) * H2,
                            m2 != nullptr ? m2 + row * H2 : nullptr,
                            dh2_c,
                            dc2_c,
                            dpre2 + row * 4 * H2,
                            H2,
                            u02,
                            first};
    switch (U2) {
      case 1: adjoint_b<1>(wb_s, dq + row * P, P, B, cell2); break;
      case 2: adjoint_b<2>(wb_s, dq + row * P, P, B, cell2); break;
      case 4: adjoint_b<4>(wb_s, dq + row * P, P, B, cell2); break;
      case 8: adjoint_b<8>(wb_s, dq + row * P, P, B, cell2); break;
    }
    grid.sync();

    const CellStep cell1{gates1 + row * 4 * H1,
                            c1 + row * H1,
                            t == 0 ? c10 : c1 + (row - B) * H1,
                            m1 != nullptr ? m1 + row * H1 : nullptr,
                            dh1_c,
                            dc1_c,
                            dpre1 + row * 4 * H1,
                            H1,
                            u01,
                            first};
    // NA = U1 with NB = U2 (phase (c)) or NQ (phase (d))
#define PAIR(NA, NB, CELL, W, X, K, OUT, HB, B0) \
  case NA * 16 + NB:                             \
    adjoint_cd<NA, NB, CELL>(W, X, K, B, cell1, OUT, HB, B0); \
    break;
#define PAIRS(CELL, W, X, K, OUT, HB, B0)                                            \
  PAIR(1, 1, CELL, W, X, K, OUT, HB, B0) PAIR(1, 2, CELL, W, X, K, OUT, HB, B0)      \
  PAIR(1, 4, CELL, W, X, K, OUT, HB, B0) PAIR(1, 8, CELL, W, X, K, OUT, HB, B0)      \
  PAIR(2, 1, CELL, W, X, K, OUT, HB, B0) PAIR(2, 2, CELL, W, X, K, OUT, HB, B0)      \
  PAIR(2, 4, CELL, W, X, K, OUT, HB, B0) PAIR(2, 8, CELL, W, X, K, OUT, HB, B0)      \
  PAIR(4, 1, CELL, W, X, K, OUT, HB, B0) PAIR(4, 2, CELL, W, X, K, OUT, HB, B0)      \
  PAIR(4, 4, CELL, W, X, K, OUT, HB, B0) PAIR(4, 8, CELL, W, X, K, OUT, HB, B0)      \
  PAIR(8, 1, CELL, W, X, K, OUT, HB, B0) PAIR(8, 2, CELL, W, X, K, OUT, HB, B0)      \
  PAIR(8, 4, CELL, W, X, K, OUT, HB, B0) PAIR(8, 8, CELL, W, X, K, OUT, HB, B0)
    switch (U1 * 16 + U2) { PAIRS(true, wc_s, dpre2 + row * 4 * H2, KC, dh2_c, H2, u02) }
    grid.sync();

    switch (U1 * 16 + NQ) { PAIRS(false, wd_s, dpre1 + row * 4 * H1, KD, dctx_c, P, q0) }
#undef PAIRS
#undef PAIR
    grid.sync();
  }
}

static cudaError_t launch(const BwdArgs& a, int grid, cudaStream_t stream) {
  auto kernel = speller_bwd_kernel;
  const size_t smem = smem_bytes(grid, a.Te, a.P, a.heads, a.H1, a.H2);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  BwdArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(NTHREADS),
                                    params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The geometry the wrapper (ops/speller_cuda.py) checks shapes against, and
// the shared memory a block of `device` may opt into: out = {MAX_GRID,
// MAX_UNITS, NTHREADS, bytes}. Returns a cudaError_t (0 on success).
extern "C" int speller_bwd_limits(int device, long long* out) {
  int optin = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  out[0] = MAX_GRID;
  out[1] = MAX_UNITS;
  out[2] = NTHREADS;
  out[3] = optin;
  return (int)err;
}

// dtype: 0 = float32, the only one this source takes (0 bytes for another).
// The wrapper checks the shapes: H1, H2 and P each `grid` x 1, 2, 4 ...
// MAX_UNITS; P a multiple of `heads`, the head width a multiple of 8; P at most
// NTHREADS 16-byte slices; the shared memory (speller_bwd_smem_bytes) within
// the device's opt-in limit.
extern "C" size_t speller_bwd_smem_bytes(int dtype, int grid, int Te, int P, int heads, int H1,
                                         int H2) {
  return dtype == 0 ? smem_bytes(grid, Te, P, heads, H1, H2) : 0;
}

// ptrs: N_PTRS device pointers in enum Ptr order (P_M1, P_M2 and P_DWUP may be
// null); dims: N_DIMS ints in enum Dim order. Returns a cudaError_t (0 on
// success).
extern "C" int speller_bwd_launch(int dtype, int grid, const void* const* ptrs, const int* dims,
                                  float scale, void* stream) {
  BwdArgs a;
  for (int i = 0; i < N_PTRS; ++i) a.p[i] = ptrs[i];
  a.B = dims[D_B];
  a.Te = dims[D_TE];
  a.T = dims[D_T];
  a.P = dims[D_P];
  a.heads = dims[D_HEADS];
  a.H1 = dims[D_H1];
  a.H2 = dims[D_H2];
  a.scale = scale;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch(a, grid, static_cast<cudaStream_t>(stream));
}
