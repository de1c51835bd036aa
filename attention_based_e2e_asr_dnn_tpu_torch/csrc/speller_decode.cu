// Fused free-running speller decode for Hopper (sm_90a): one cooperative
// launch runs every step of the eval decode for the whole batch.
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/speller_pallas.py):
//   _decode_fwd_kernel (:90) as _fwd_chunk (:465) launches it with
//   save_residuals=False and no dropout: the eval form of TPU kernel #8.
//   Each step selects the input id (a forced id >= 0, else the id fed back by
//   the previous step; <sos> at step 0), runs cell 1, cell 2, the query
//   projection, the masked-softmax cross-attention of every head, the tied
//   classifier and the first-max argmax that feeds the next step.
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
// H2 256, P 256) a step is ~1.3M MACs for a batch row of cells and 2 x Te x P
// for the attention: too little work to fill the card, so a step's cost is
// its grid barriers (~1.2 us each, measured) plus the latency of each
// phase's chain of loads, shuffles and stores, which grows with the rows a
// warp walks (PERF.md has the per-phase ablation).
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
// on the CUDA cores; tensor cores are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROWS = 2;   // batch rows a warp carries at once in the cell and query phases
constexpr int VMAX = 32;  // padded vocabulary: one lane per entry
constexpr int MAX_GRID = 128;  // blocks of a launch, at most: a power of two, one per SM
constexpr int MAX_UNITS = 8;   // units of a cell (query columns) a block owns, at most:
                               // the largest case of the phase switches in the kernel
constexpr unsigned FULL = 0xffffffffu;

// pointer slots of the launch (the order of ops/speller_cuda.py's list)
enum Ptr {
  P_K, P_V, P_BIAS, P_CTX0, P_H10, P_C10, P_H20, P_C20, P_EMBW1, P_WC1, P_WHH1, P_WIH2,
  P_WHH2, P_B2, P_WQ, P_BQ, P_WCLS, P_CLSB, P_FORCED, P_LOGITS, P_WGTS, P_IDS, P_H1X,
  P_H2X, P_CTXX, P_QX, P_C1, P_C2, P_PREV, N_PTRS
};
// int slots
enum Dim { D_B, D_TE, D_T, D_P, D_HEADS, D_H1, D_H2, D_VP, D_SOS, N_DIMS };

struct DecodeArgs {
  const void* p[N_PTRS];
  int B, Te, T, P, heads, H1, H2, Vp, sos;
  float scale;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}
// the value v.astype(T) leaves
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// scalar loads: L2 only (ld.cg) for buffers other blocks write during the
// launch; the read-only path for inputs
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float ld_nc(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_nc(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// 16 bytes -> 4 or 8 floats
__device__ __forceinline__ void unpack16(uint4 v, float* dst, const float*) {
  dst[0] = __uint_as_float(v.x);
  dst[1] = __uint_as_float(v.y);
  dst[2] = __uint_as_float(v.z);
  dst[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(uint4 v, float* dst, const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
template <typename T> __device__ __forceinline__ void load16_cg(const T* p, float* dst) {
  unpack16(__ldcg(reinterpret_cast<const uint4*>(p)), dst, p);
}
template <typename T> __device__ __forceinline__ void load16_nc(const T* p, float* dst) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), dst, p);
}
template <typename T> __device__ __forceinline__ void load16_smem(const T* p, float* dst) {
  unpack16(*reinterpret_cast<const uint4*>(p), dst, p);
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

// acc[i][c] += x[rows[i], 0:len] . w_s[c * w_stride + w_off + (0:len)] over
// this lane's 16-byte slices of x (lane * VEC, + 32 * VEC, ...); x rows are
// len apart. The rows' loads go out together and each weight slice is read
// from shared memory once for all rows.
template <typename T, int NC>
__device__ __forceinline__ void dot_rows(float (*acc)[NC], const T* x, int len, const int* rows,
                                         const T* w_s, int w_stride, int w_off, int lane) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll 2
  for (int k = lane * VEC; k < len; k += 32 * VEC) {
    float xv[ROWS][VEC];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) load16_cg(x + (long long)rows[i] * len + k, xv[i]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float wv[VEC];
      load16_smem(w_s + c * w_stride + w_off + k, wv);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[i][c] = fmaf(xv[i][j], wv[j], acc[i][c]);
    }
  }
}

// The rows a warp carries at once: r0, r0 + NWARPS, ...; a row past the
// batch repeats r0 (computed, never written).
__device__ __forceinline__ void warp_rows(int r0, int B, int* rows, bool* live) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    live[i] = r0 + i * NWARPS < B;
    rows[i] = live[i] ? r0 + i * NWARPS : r0;
  }
}

// Transposing butterfly over the warp: on entry each lane holds N partial
// sums; on exit acc[0] of every lane holds the warp-wide sum of column
// lane >> (5 - log2 N). Each halving step sends half the columns to the
// partner lane and keeps the other half (N - 1 shuffles in all), then plain
// butterflies finish.
template <int N, int O>
__device__ __forceinline__ void halve(float* acc, int lane) {
  if constexpr (N > 1) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = upper ? acc[j] : acc[j + N / 2];
      const float keep = upper ? acc[j + N / 2] : acc[j];
      acc[j] = keep + __shfl_xor_sync(FULL, send, O);
    }
    halve<N / 2, O / 2>(acc, lane);
  } else {
#pragma unroll
    for (int o = O; o >= 1; o >>= 1) acc[0] += __shfl_xor_sync(FULL, acc[0], o);
  }
}

// One LSTM cell step for every batch row, this block's NC / 4 units
// [u0, u0 + NC / 4): pre = [x0 | x1] . W_s + extra, gates [i, f, g, o] in
// fp32. Column c of w_s is gate c / U of unit u0 + c % U. extra is embw1's row
// of the input id (cell 1: forced id, else the fed-back one) or b2 (cell 2,
// prev == nullptr).
template <typename T, int NC>
__device__ __forceinline__ void cell_phase(const T* w_s, const T* x0, int K0, const T* x1, int K1,
                                           int H, int u0, const T* extra, const int* forced_t,
                                           const int* prev, float* c, T* h_next, int B) {
  constexpr int U = NC / 4;
  constexpr int SHIFT = 5 - log2i(NC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int u = lane % U;
  for (int r0 = warp; r0 < B; r0 += ROWS * NWARPS) {
    int rows[ROWS];
    bool live[ROWS];
    warp_rows(r0, B, rows, live);
    // the rows' extras and carries load before the dot, behind its latency
    float ex[ROWS][4], c_old[ROWS];
    if (lane < U) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        int id = 0;
        if (prev != nullptr) {
          id = forced_t != nullptr ? forced_t[rows[i]] : -1;
          if (id < 0) id = __ldcg(prev + rows[i]);
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
        h_next[(long long)rows[i] * H + u0 + u] = from_f<T>(og * tanhf(cn));
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
__device__ __forceinline__ void attend_phase(const DecodeArgs& a, int t, float* q_s, float* ctx_s,
                                             float* part_s, float* red_s, float* sc_s) {
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
  T* ctxx = static_cast<T*>(const_cast<void*>(a.p[P_CTXX]));
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
      ctxx[(long long)r * P + p] = from_f<T>(acc);
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

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// bytes of dynamic shared memory: the three weight slices in T, then fp32
// q, ctx, classifier partials, the context's group sums and the scores of
// every head
static size_t smem_bytes(size_t elem, int grid, int Te, int P, int heads, int H1, int H2) {
  const size_t nc1 = 4 * (H1 / grid), nc2 = 4 * (H2 / grid), nq = P / grid;
  const size_t weights = (nc1 * (P + H1) + nc2 * (H1 + H2) + nq * H2) * elem;
  const size_t floats = 2 * (size_t)P + NWARPS * VMAX + NTHREADS * (16 / elem) + (size_t)heads * Te;
  return align16(weights) + floats * sizeof(float);
}

template <typename T>
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

  // the t = -1 state: h and ctx as given (T), c as fp32, <sos> fed back
  {
    const T* h10 = static_cast<const T*>(a.p[P_H10]);
    const T* c10 = static_cast<const T*>(a.p[P_C10]);
    const T* h20 = static_cast<const T*>(a.p[P_H20]);
    const T* c20 = static_cast<const T*>(a.p[P_C20]);
    const T* ctx0 = static_cast<const T*>(a.p[P_CTX0]);
    const long long tid = (long long)blockIdx.x * NTHREADS + threadIdx.x;
    const long long stride = (long long)G * NTHREADS;
    for (long long i = tid; i < (long long)B * H1; i += stride) {
      h1x[i] = h10[i];
      c1[i] = to_f(c10[i]);
    }
    for (long long i = tid; i < (long long)B * H2; i += stride) {
      h2x[i] = h20[i];
      c2[i] = to_f(c20[i]);
    }
    for (long long i = tid; i < (long long)B * P; i += stride) ctxx[i] = ctx0[i];
    for (long long i = tid; i < B; i += stride) prev[i] = a.sos;
  }
  cg::grid_group grid = cg::this_grid();
  grid.sync();

  const T* embw1 = static_cast<const T*>(a.p[P_EMBW1]);
  const T* b2 = static_cast<const T*>(a.p[P_B2]);
  const T* bq = static_cast<const T*>(a.p[P_BQ]);
  const int* forced = static_cast<const int*>(a.p[P_FORCED]);
  for (int t = 0; t < a.T; ++t) {
    const T* h1_prev = h1x + (long long)(t & 1) * B * H1;
    T* h1_next = h1x + (long long)((t + 1) & 1) * B * H1;
    const T* h2_prev = h2x + (long long)(t & 1) * B * H2;
    T* h2_next = h2x + (long long)((t + 1) & 1) * B * H2;
    const int* forced_t = forced != nullptr ? forced + (long long)t * B : nullptr;

#define CELL1(NC)                                                                          \
  case NC:                                                                                 \
    cell_phase<T, NC>(w1_s, ctxx, P, h1_prev, H1, H1, u01, embw1, forced_t, prev, c1, h1_next, B); \
    break;
    switch (4 * U1) { CELL1(4) CELL1(8) CELL1(16) CELL1(32) }
#undef CELL1
    grid.sync();

#define CELL2(NC)                                                                              \
  case NC:                                                                                     \
    cell_phase<T, NC>(w2_s, h1_next, H1, h2_prev, H2, H2, u02, b2, nullptr, nullptr, c2, h2_next, B); \
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

    attend_phase<T>(a, t, q_s, ctx_s, part_s, red_s, sc_s);
    grid.sync();
  }
}

template <typename T>
static cudaError_t launch(const DecodeArgs& a, int grid, cudaStream_t stream) {
  auto kernel = speller_decode_kernel<T>;
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

// dtype: 0 = float32, 1 = bfloat16. The wrapper checks the shapes: H1, H2
// and P each `grid` x 1, 2, 4 ... MAX_UNITS; P a multiple of `heads`, the
// head width a multiple of 8; Vp <= VMAX; the shared memory
// (speller_decode_smem_bytes) within the device's opt-in limit.
extern "C" size_t speller_decode_smem_bytes(int dtype, int grid, int Te, int P, int heads, int H1,
                                            int H2) {
  return smem_bytes(dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16), grid, Te, P, heads, H1,
                    H2);
}

// ptrs: N_PTRS device pointers in enum Ptr order (P_FORCED may be null);
// dims: N_DIMS ints in enum Dim order. Returns a cudaError_t (0 on success).
extern "C" int speller_decode_launch(int dtype, int grid, const void* const* ptrs, const int* dims,
                                     float scale, void* stream) {
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
  if (dtype == 0) return launch<float>(a, grid, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}
