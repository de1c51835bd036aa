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
// What bounds it: 4 x T dependent phases, each short. At base-LAS (H1 512,
// H2 256, P 256) a step is ~2.4M MACs for a batch row of cells and 2 x Te x P
// for the attention: too little work to fill the card, so a step's cost is
// its grid barriers (~1.2 us each, measured) plus the latency of each
// phase's chain of loads, shuffles and stores, which grows with the rows a
// warp walks: the bfloat16 form of this body took ~25 us plus ~0.55 us a
// batch row a step at base-LAS (PERF.md, the decode's B-scaling).
//
// Design. A persistent grid of G blocks (G = 128 at base- and scaled-LAS; every
// block resident, one per SM) walks all T steps. Block g owns U1 = H1 / G
// hidden units of cell 1, U2 = H2 / G of cell 2 and NQ = P / G query columns,
// and keeps those columns of [wc1; whh1], [wih2; whh2] and wq in shared memory
// in the weight dtype for the whole launch. Per step:
//   1. cell 1: warp w takes rows w and w + 8 together, then w + 16 and
//      w + 24, ...; its lanes split the input vectors [ctx; h1] (16-byte
//      loads from L2, both rows' in flight together) and accumulate the
//      block's 4 * U1 gate columns; a transposing butterfly leaves each
//      column's sum on its own lanes; the lanes of each unit apply the gates,
//      update the fp32 c carry (global, touched by this thread only; loaded
//      with the row's embw1 entries before the dot) and write h1 rounded to
//      the weight dtype into a double-buffered exchange buffer;
//   2. cell 2 the same over [h1; h2]; 3. the query columns over h2;
//   4. block r takes batch row r (r += G): scores (thread per head and frame),
//      softmax (warp per head), context (thread per frame group and 16-byte
//      column slice, the groups summed in shared memory), classifier (warp
//      per slice of the 2P inputs, lane per vocabulary entry), first-max
//      argmax; writes ctx, the fed-back id, logits and weights.
// One grid-wide barrier (cooperative groups) ends each phase. K and V stream
// from global memory each step; for one step they are L2-resident. Plain FMA
// on the CUDA cores (float32 keeps its 1e-4 tolerance, which TF32 tensor
// cores would not).

#include <cooperative_groups.h>

#include "speller_common.cuh"

namespace cg = cooperative_groups;

constexpr int VMAX = 32;  // padded vocabulary: one lane per entry

// pointer slots of the launch (the order of ops/speller_cuda.py's list)
enum Ptr {
  P_K, P_V, P_BIAS, P_CTX0, P_H10, P_C10, P_H20, P_C20, P_EMBW1, P_WC1, P_WHH1, P_WIH2,
  P_WHH2, P_B2, P_WQ, P_BQ, P_WCLS, P_CLSB, P_FORCED, P_LOGITS, P_WGTS, P_IDS, P_H1X,
  P_H2X, P_CTXX, P_QX, P_C1, P_C2, P_PREV,
  // the training form's masks (null: no dropout) and residual streams
  P_M1, P_M2, P_SEL, P_GATES1, P_C1R, P_H1D, P_GATES2, P_C2R, P_H2D, P_CTXR, N_PTRS
};
// int slots
enum Dim { D_B, D_TE, D_T, D_P, D_HEADS, D_H1, D_H2, D_VP, D_SOS, N_DIMS };

struct DecodeArgs {
  const void* p[N_PTRS];
  int B, Te, T, P, heads, H1, H2, Vp, sos;
  float scale;
};

// The training form's streams of one cell at one step: the dropout mask (B, H)
// (null: none), the activated gates (B, 4H), c (B, H) and, for cell 1, the fed
// id (B,).
template <typename T> struct CellStreams {
  const T* mask;
  T* gates;
  T* c;
  int* sel;
};

// One LSTM cell step for every batch row, this block's NC / 4 units
// [u0, u0 + NC / 4): pre = [x0 | x1] . W_s + extra, gates [i, f, g, o] in
// fp32. Column c of w_s is gate c / U of unit u0 + c % U. extra is embw1's row
// of the input id (cell 1: forced id, else the fed-back one) or b2 (cell 2,
// prev == nullptr). TRAIN: h is multiplied by the mask before it is rounded,
// and the gates, c and the fed id are stored.
template <typename T, int NC, bool TRAIN>
__device__ __forceinline__ void cell_phase(const T* w_s, const T* x0, int K0, const T* x1, int K1,
                                           int H, int u0, const T* extra, const int* forced_t,
                                           const int* prev, float* c, T* h_next, int B,
                                           const CellStreams<T>& st) {
  constexpr int U = NC / 4;
  constexpr int SHIFT = 5 - log2i(NC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int u = lane % U;
  for (int r0 = warp; r0 < B; r0 += ROWS * NWARPS) {
    int rows[ROWS];
    bool live[ROWS];
    warp_rows(r0, B, rows, live);
    // the rows' extras and carries load before the dot, behind its latency
    float ex[ROWS][4], c_old[ROWS], keep[ROWS];
    if (lane < U) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        int id = 0;
        if (prev != nullptr) {
          id = forced_t != nullptr ? forced_t[rows[i]] : -1;
          if (id < 0) id = __ldcg(prev + rows[i]);
          if constexpr (TRAIN) {
            if (blockIdx.x == 0 && lane == 0 && live[i]) st.sel[rows[i]] = id;
          }
        }
        if constexpr (TRAIN) {
          keep[i] = st.mask != nullptr ? to_f(st.mask[(long long)rows[i] * H + u0 + u]) : 1.0f;
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) ex[i][g] = to_f(extra[(long long)id * 4 * H + g * H + u0 + u]);
        c_old[i] = c[(long long)rows[i] * H + u0 + u];
      }
    }
    float acc[ROWS][NC];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
    dot_rows<T, NC>(acc, x0, K0, rows, w_s, K0 + K1, 0, lane);
    dot_rows<T, NC>(acc, x1, K1, rows, w_s, K0 + K1, K0, lane);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      halve<NC, 16>(acc[i], lane);
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) pre[g] = __shfl_sync(FULL, acc[i][0], (g * U + u) << SHIFT);
      if (lane < U && live[i]) {
#pragma unroll
        for (int g = 0; g < 4; ++g) pre[g] += ex[i][g];
        const float ig = sigmoidf(pre[0]);
        const float fg = sigmoidf(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoidf(pre[3]);
        const float cn = fg * c_old[i] + ig * gg;
        c[(long long)rows[i] * H + u0 + u] = cn;
        float hn = og * tanhf(cn);
        if constexpr (TRAIN) {
          if (st.mask != nullptr) hn *= keep[i];
          T* grow = st.gates + (long long)rows[i] * 4 * H + u0 + u;
          grow[0] = from_f<T>(ig);
          grow[H] = from_f<T>(fg);
          grow[2 * H] = from_f<T>(gg);
          grow[3 * H] = from_f<T>(og);
          st.c[(long long)rows[i] * H + u0 + u] = from_f<T>(cn);
        }
        h_next[(long long)rows[i] * H + u0 + u] = from_f<T>(hn);
      }
    }
  }
}

// out[r, c0 + c] = x[r] . w_s[c] + bias[c0 + c] for this block's NC columns
template <typename T, int NC>
__device__ __forceinline__ void linear_phase(const T* w_s, const T* x, int K, int n_out, int c0,
                                             const T* bias, T* out, int B) {
  constexpr int SHIFT = 5 - log2i(NC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp; r0 < B; r0 += ROWS * NWARPS) {
    int rows[ROWS];
    bool live[ROWS];
    warp_rows(r0, B, rows, live);
    float acc[ROWS][NC];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
    dot_rows<T, NC>(acc, x, K, rows, w_s, K, 0, lane);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      halve<NC, 16>(acc[i], lane);
      if (live[i] && (lane & ((1 << SHIFT) - 1)) == 0) {
        const int col = c0 + (lane >> SHIFT);
        out[(long long)rows[i] * n_out + col] = from_f<T>(acc[i][0] + to_f(bias[col]));
      }
    }
  }
}

// Attention, classifier and feedback for the rows of this block.
template <typename T>
__device__ __forceinline__ void attend_phase(const DecodeArgs& a, int t, T* ctx_out, float* q_s,
                                             float* ctx_s, float* part_s, float* red_s,
                                             float* sc_s) {
  constexpr int VEC = 16 / sizeof(T);
  const int P = a.P, Te = a.Te, heads = a.heads, Vp = a.Vp, B = a.B;
  const int d = P / heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* kmat = static_cast<const T*>(a.p[P_K]);
  const T* vmat = static_cast<const T*>(a.p[P_V]);
  const T* bias = static_cast<const T*>(a.p[P_BIAS]);
  const T* wcls = static_cast<const T*>(a.p[P_WCLS]);
  const T* clsb = static_cast<const T*>(a.p[P_CLSB]);
  const T* qx = static_cast<const T*>(a.p[P_QX]);
  T* logits = static_cast<T*>(const_cast<void*>(a.p[P_LOGITS]));
  T* wgts = static_cast<T*>(const_cast<void*>(a.p[P_WGTS]));
  int* ids = static_cast<int*>(const_cast<void*>(a.p[P_IDS]));
  int* prev = static_cast<int*>(const_cast<void*>(a.p[P_PREV]));

  for (int r = blockIdx.x; r < B; r += gridDim.x) {
    // q (already rounded to T by the query phase)
    for (int p = threadIdx.x; p < P; p += NTHREADS) q_s[p] = ld_cg(qx + (long long)r * P + p);
    __syncthreads();

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
    __syncthreads();

    // softmax per head (warp h), weights out in T
    T* wrow = wgts + ((long long)t * B + r) * heads * Te;
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
    __syncthreads();

    // context[p] = sum_te w[h(p)][te] * v[te, p], w rounded to T: thread
    // (group g, slice s) sums frames g, g + groups, ... of the VEC columns
    // of slice s (one head's: d % VEC == 0) with 16-byte loads; the groups'
    // sums meet in shared memory
    const T* vrow = vmat + (long long)r * Te * P;
    const int slices = P / VEC, groups = NTHREADS / slices;
    const int g = threadIdx.x / slices, p0 = (threadIdx.x % slices) * VEC;
    if (g < groups) {
      const float* wh = sc_s + (p0 / d) * Te;
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
#pragma unroll 4
      for (int te = g; te < Te; te += groups) {
        float vv[VEC];
        load16_nc(vrow + (long long)te * P + p0, vv);
        const float w = round_to<T>(wh[te]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += __fmul_rn(w, vv[j]);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) red_s[g * P + p0 + j] = acc[j];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < P; p += NTHREADS) {
      float acc = 0.0f;
      for (int k = 0; k < groups; ++k) acc += red_s[k * P + p];
      ctx_s[p] = round_to<T>(acc);
      ctx_out[(long long)r * P + p] = from_f<T>(acc);
    }
    __syncthreads();

    // tied classifier over cat(q, ctx): warp w sums its slice of the 2P
    // inputs for vocabulary entry `lane`
    {
      const int span = 2 * P / NWARPS;
      float part = 0.0f;
      if (lane < Vp)
        for (int e = warp * span; e < (warp + 1) * span; ++e) {
          const float x = e < P ? q_s[e] : ctx_s[e - P];
          part = fmaf(x, ld_nc(wcls + (long long)e * Vp + lane), part);
        }
      part_s[warp * 32 + lane] = part;
    }
    __syncthreads();
    if (warp == 0) {
      float logit = -CUDART_INF_F;
      if (lane < Vp) {
        float s = 0.0f;
        for (int w = 0; w < NWARPS; ++w) s += part_s[w * 32 + lane];
        logit = s + ld_nc(clsb + lane);
        logits[((long long)t * B + r) * Vp + lane] = from_f<T>(logit);
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
    __syncthreads();  // the row's shared buffers are reused by the next row
  }
}

// bytes of dynamic shared memory: the three weight slices in T, then fp32
// q, ctx, classifier partials, the context's group sums and the scores of
// every head
static size_t smem_bytes(size_t elem, int grid, int Te, int P, int heads, int H1, int H2) {
  const size_t nc1 = 4 * (H1 / grid), nc2 = 4 * (H2 / grid), nq = P / grid;
  const size_t weights = (nc1 * (P + H1) + nc2 * (H1 + H2) + nq * H2) * elem;
  const size_t floats = 2 * (size_t)P + NWARPS * VMAX + NTHREADS * (16 / elem) + (size_t)heads * Te;
  return align16(weights) + floats * sizeof(float);
}

template <typename T, bool TRAIN>
__global__ void __launch_bounds__(NTHREADS, 1) speller_decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P, H1 = a.H1, H2 = a.H2, B = a.B, G = gridDim.x;
  const int U1 = H1 / G, U2 = H2 / G, NQ = P / G;
  const int K1 = P + H1, K2 = H1 + H2;
  const int u01 = blockIdx.x * U1, u02 = blockIdx.x * U2, q0 = blockIdx.x * NQ;

  T* w1_s = reinterpret_cast<T*>(smem_raw);
  T* w2_s = w1_s + 4 * U1 * K1;
  T* wq_s = w2_s + 4 * U2 * K2;
  float* q_s = reinterpret_cast<float*>(
      smem_raw + align16(((size_t)4 * U1 * K1 + 4 * U2 * K2 + NQ * H2) * sizeof(T)));
  float* ctx_s = q_s + P;
  float* part_s = ctx_s + P;
  float* red_s = part_s + NWARPS * VMAX;
  float* sc_s = red_s + NTHREADS * (16 / sizeof(T));

  const T* wc1 = static_cast<const T*>(a.p[P_WC1]);
  const T* whh1 = static_cast<const T*>(a.p[P_WHH1]);
  const T* wih2 = static_cast<const T*>(a.p[P_WIH2]);
  const T* whh2 = static_cast<const T*>(a.p[P_WHH2]);
  const T* wq = static_cast<const T*>(a.p[P_WQ]);
  // this block's weight columns, [column][k], for the whole launch
  for (int idx = threadIdx.x; idx < 4 * U1 * K1; idx += NTHREADS) {
    const int c = idx / K1, k = idx % K1;
    const long long col = (c / U1) * H1 + u01 + c % U1;
    w1_s[idx] = k < P ? wc1[(long long)k * 4 * H1 + col] : whh1[(long long)(k - P) * 4 * H1 + col];
  }
  for (int idx = threadIdx.x; idx < 4 * U2 * K2; idx += NTHREADS) {
    const int c = idx / K2, k = idx % K2;
    const long long col = (c / U2) * H2 + u02 + c % U2;
    w2_s[idx] = k < H1 ? wih2[(long long)k * 4 * H2 + col] : whh2[(long long)(k - H1) * 4 * H2 + col];
  }
  for (int idx = threadIdx.x; idx < NQ * H2; idx += NTHREADS) {
    const int c = idx / H2, k = idx % H2;
    wq_s[idx] = wq[(long long)k * P + q0 + c];
  }

  T* h1x = static_cast<T*>(const_cast<void*>(a.p[P_H1X]));
  T* h2x = static_cast<T*>(const_cast<void*>(a.p[P_H2X]));
  T* ctxx = static_cast<T*>(const_cast<void*>(a.p[P_CTXX]));
  T* qx = static_cast<T*>(const_cast<void*>(a.p[P_QX]));
  float* c1 = static_cast<float*>(const_cast<void*>(a.p[P_C1]));
  float* c2 = static_cast<float*>(const_cast<void*>(a.p[P_C2]));
  int* prev = static_cast<int*>(const_cast<void*>(a.p[P_PREV]));

  // the t = -1 state: h and ctx as given (T), c as fp32, <sos> fed back. The
  // training form reads h and ctx of t = -1 where they are, and afterwards
  // from its h1d, h2d and context streams.
  const T* h10 = static_cast<const T*>(a.p[P_H10]);
  const T* h20 = static_cast<const T*>(a.p[P_H20]);
  const T* ctx0 = static_cast<const T*>(a.p[P_CTX0]);
  {
    const T* c10 = static_cast<const T*>(a.p[P_C10]);
    const T* c20 = static_cast<const T*>(a.p[P_C20]);
    const long long tid = (long long)blockIdx.x * NTHREADS + threadIdx.x;
    const long long stride = (long long)G * NTHREADS;
    for (long long i = tid; i < (long long)B * H1; i += stride) {
      if constexpr (!TRAIN) h1x[i] = h10[i];
      c1[i] = to_f(c10[i]);
    }
    for (long long i = tid; i < (long long)B * H2; i += stride) {
      if constexpr (!TRAIN) h2x[i] = h20[i];
      c2[i] = to_f(c20[i]);
    }
    if constexpr (!TRAIN)
      for (long long i = tid; i < (long long)B * P; i += stride) ctxx[i] = ctx0[i];
    for (long long i = tid; i < B; i += stride) prev[i] = a.sos;
  }
  cg::grid_group grid = cg::this_grid();
  grid.sync();

  const T* embw1 = static_cast<const T*>(a.p[P_EMBW1]);
  const T* b2 = static_cast<const T*>(a.p[P_B2]);
  const T* bq = static_cast<const T*>(a.p[P_BQ]);
  const int* forced = static_cast<const int*>(a.p[P_FORCED]);
  const T* m1 = static_cast<const T*>(a.p[P_M1]);
  const T* m2 = static_cast<const T*>(a.p[P_M2]);
  int* sel = static_cast<int*>(const_cast<void*>(a.p[P_SEL]));
  T* gates1 = static_cast<T*>(const_cast<void*>(a.p[P_GATES1]));
  T* c1r = static_cast<T*>(const_cast<void*>(a.p[P_C1R]));
  T* h1d = static_cast<T*>(const_cast<void*>(a.p[P_H1D]));
  T* gates2 = static_cast<T*>(const_cast<void*>(a.p[P_GATES2]));
  T* c2r = static_cast<T*>(const_cast<void*>(a.p[P_C2R]));
  T* h2d = static_cast<T*>(const_cast<void*>(a.p[P_H2D]));
  T* ctxr = static_cast<T*>(const_cast<void*>(a.p[P_CTXR]));
  for (int t = 0; t < a.T; ++t) {
    const T *h1_prev, *h2_prev, *ctx_prev;
    T *h1_next, *h2_next, *ctx_next;
    CellStreams<T> st1{nullptr, nullptr, nullptr, nullptr}, st2{nullptr, nullptr, nullptr, nullptr};
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

#define CELL1(NC)                                                                              \
  case NC:                                                                                     \
    cell_phase<T, NC, TRAIN>(w1_s, ctx_prev, P, h1_prev, H1, H1, u01, embw1, forced_t, prev, c1, \
                             h1_next, B, st1);                                                 \
    break;
    switch (4 * U1) { CELL1(4) CELL1(8) CELL1(16) CELL1(32) }
#undef CELL1
    grid.sync();

#define CELL2(NC)                                                                              \
  case NC:                                                                                     \
    cell_phase<T, NC, TRAIN>(w2_s, h1_next, H1, h2_prev, H2, H2, u02, b2, nullptr, nullptr, c2, \
                             h2_next, B, st2);                                                 \
    break;
    switch (4 * U2) { CELL2(4) CELL2(8) CELL2(16) CELL2(32) }
#undef CELL2
    grid.sync();

#define QUERY(NC)                                                  \
  case NC:                                                         \
    linear_phase<T, NC>(wq_s, h2_next, H2, P, q0, bq, qx, B);      \
    break;
    switch (NQ) { QUERY(1) QUERY(2) QUERY(4) QUERY(8) }
#undef QUERY
    grid.sync();

    attend_phase<T>(a, t, ctx_next, q_s, ctx_s, part_s, red_s, sc_s);
    grid.sync();
  }
}

template <typename T, bool TRAIN>
static cudaError_t launch(const DecodeArgs& a, int grid, cudaStream_t stream) {
  auto kernel = speller_decode_kernel<T, TRAIN>;
  const size_t smem = smem_bytes(sizeof(T), grid, a.Te, a.P, a.heads, a.H1, a.H2);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  DecodeArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(NTHREADS),
                                    params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The geometry the wrapper (ops/speller_cuda.py) checks shapes against, and
// the shared memory a block of `device` may opt into: out = {MAX_GRID,
// MAX_UNITS, NTHREADS, VMAX, bytes}. Returns a cudaError_t (0 on success).
extern "C" int speller_decode_limits(int device, long long* out) {
  int optin = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  out[0] = MAX_GRID;
  out[1] = MAX_UNITS;
  out[2] = NTHREADS;
  out[3] = VMAX;
  out[4] = optin;
  return (int)err;
}

// dtype: 0 = float32 (the only one this source instantiates; bfloat16 is
// speller_decode_tc.cu's). The wrapper checks the shapes: H1, H2
// and P each `grid` x 1, 2, 4 ... MAX_UNITS; P a multiple of `heads`, the
// head width a multiple of 8; Vp <= VMAX; the shared memory
// (speller_decode_smem_bytes) within the device's opt-in limit.
extern "C" size_t speller_decode_smem_bytes(int dtype, int grid, int Te, int P, int heads, int H1,
                                            int H2) {
  return smem_bytes(dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16), grid, Te, P, heads, H1,
                    H2);
}

// ptrs: N_PTRS device pointers in enum Ptr order (P_FORCED may be null; with
// train == 0 the slots from P_M1 on are not read; with train != 0 P_M1 and
// P_M2 may be null, and P_H1X, P_H2X and P_CTXX are not touched); dims: N_DIMS
// ints in enum Dim order. Returns a cudaError_t (0 on success).
extern "C" int speller_decode_launch(int dtype, int train, int grid, const void* const* ptrs,
                                     const int* dims, float scale, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return train ? launch<float, true>(a, grid, s) : launch<float, false>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}
