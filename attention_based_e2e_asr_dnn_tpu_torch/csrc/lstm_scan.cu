// Persistent LSTM recurrence for Hopper (sm_90a): one cooperative launch runs
// the whole time loop of one listener layer, one or both directions.
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py):
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
// Plain FMA on the CUDA cores; wgmma/TMA are later work.

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

struct ScanArgs {
  const void* x;        // FUSED_IN: (B, T, D) input; else (B, T, ndir*4H) x_proj
  long long x_sd, x_sb, x_st;   // element strides: direction, batch, time
  const void* w_ih;     // FUSED_IN: (ndir, D, 4H)
  const void* bias;     // FUSED_IN: (ndir, 4H)
  const void* w_hh;     // (ndir, H, 4H)
  const int* lengths;   // (B,)
  void* out;            // (B, T, ndir*H)
  long long o_sd, o_sb, o_st;
  void* hbuf;           // (2, ndir, B, H) exchange buffer, weight dtype
  void* cs;             // TRAIN: (B, T, ndir*H), out's strides
  void* gates;          // TRAIN: (B, T, ndir*4H)
  long long g_sd, g_sb, g_st;
  int ndir, rev_bits, B, T, D, H;
};

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

template <typename T, bool FUSED_IN, bool TRAIN, bool WIDE>
__global__ void __launch_bounds__(NTHREADS, 1) lstm_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, B = a.B, seq_len = a.T, D = a.D;
  const int blocks_per_dir = H / UNITS;
  const int d = blockIdx.x / blocks_per_dir;
  const int u0 = (blockIdx.x % blocks_per_dir) * UNITS;
  const bool rev = (a.rev_bits >> d) & 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int PASSES = WIDE ? 2 : 1;  // pieces of the k range staged in turn
  const int SW = H / PASSES;            // columns of h staged at a time
  const int hs_stride = SW + 4;  // padded rows: conflict-free float4 reads
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load

  // shared memory: W_hh slice [H][UNITS][4]; h rows [BMAX][SW + 4], reused as
  // the cross-warp reduction buffer [NWARPS][UNITS][4][32]; then the fused
  // input projection's W_ih slice [D][UNITS][4] and bias [UNITS][4].
  float* w_s = smem;
  float* h_s = w_s + H * UNITS * 4;
  float* red_s = h_s;
  const int h_region = max(BMAX * hs_stride, NWARPS * UNITS * 4 * 32);
  float* wih_s = h_s + h_region;
  float* b_s = wih_s + D * UNITS * 4;

  const T* w_hh = static_cast<const T*>(a.w_hh) + (long long)d * H * 4 * H;
  for (int idx = threadIdx.x; idx < H * UNITS * 4; idx += NTHREADS) {
    const int k = idx / (UNITS * 4), u = (idx / 4) % UNITS, g = idx % 4;
    w_s[idx] = to_f(w_hh[(long long)k * 4 * H + g * H + u0 + u]);
  }
  if (FUSED_IN) {
    const T* w_ih = static_cast<const T*>(a.w_ih) + (long long)d * D * 4 * H;
    const T* bias = static_cast<const T*>(a.bias) + (long long)d * 4 * H;
    for (int idx = threadIdx.x; idx < D * UNITS * 4; idx += NTHREADS) {
      const int k = idx / (UNITS * 4), u = (idx / 4) % UNITS, g = idx % 4;
      wih_s[idx] = to_f(w_ih[(long long)k * 4 * H + g * H + u0 + u]);
    }
    if (threadIdx.x < UNITS * 4) {
      const int u = threadIdx.x / 4, g = threadIdx.x % 4;
      b_s[threadIdx.x] = to_f(bias[g * H + u0 + u]);
    }
  }

  // the cell-update thread: unit u0 + warp, batch row lane
  const int cu = warp, cb = lane;
  const bool row_live = cb < B;
  const int len = row_live ? a.lengths[cb] : 0;
  float h_carry = 0.0f, c_carry = 0.0f;

  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  T* cs = static_cast<T*>(a.cs);
  T* gates = static_cast<T*>(a.gates);
  T* hbuf = static_cast<T*>(a.hbuf);
  const long long hbuf_half = (long long)a.ndir * B * H;
  const int k_chunk = SW / NWARPS;
  const int k0 = warp * k_chunk;
  cg::grid_group grid = cg::this_grid();

  for (int s = 0; s < seq_len; ++s) {
    const int t = rev ? seq_len - 1 - s : s;
    float acc[UNITS][4];
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[u][g] = 0.0f;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      // 1. h_{t-1} (rows < B, columns [p * SW, p * SW + SW)) into shared
      //    memory: zero at the first step, else 16-byte loads that bypass L1
      //    (other blocks wrote them), all issued before any is converted.
      //    Rows >= B hold stale values; their lanes compute on them and write
      //    nothing.
      if (s == 0) {
        for (int idx = threadIdx.x; idx < B * SW; idx += NTHREADS)
          h_s[(idx / SW) * hs_stride + idx % SW] = 0.0f;
      } else if (WIDE) {
        stage_rows(h_s, hs_stride, hbuf + (s & 1) * hbuf_half + (long long)d * B * H + p * SW,
                   (long long)H, B, SW);
      } else {
        const uint4* h_prev = reinterpret_cast<const uint4*>(
            hbuf + (s & 1) * hbuf_half + (long long)d * B * H);
        const int chunks_per_row = H / VEC;
        const int n_chunks = B * chunks_per_row;
        for (int base = threadIdx.x; base < n_chunks; base += NTHREADS * LOAD_BATCH) {
          uint4 buf[LOAD_BATCH];
#pragma unroll
          for (int j = 0; j < LOAD_BATCH; ++j) {
            const int c = base + j * NTHREADS;
            if (c < n_chunks) buf[j] = __ldcg(h_prev + c);
          }
#pragma unroll
          for (int j = 0; j < LOAD_BATCH; ++j) {
            const int c = base + j * NTHREADS;
            if (c < n_chunks)
              unpack16(buf[j], h_s + (c / chunks_per_row) * hs_stride + (c % chunks_per_row) * VEC,
                       static_cast<const T*>(nullptr));
          }
        }
      }
      __syncthreads();

      // 2. partial recurrent dots for batch row `lane`, k in this warp's chunk
      const float* hrow = h_s + lane * hs_stride;
      const float* w_p = w_s + (long long)p * SW * UNITS * 4;
      for (int k = k0; k < k0 + k_chunk; k += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hrow + k);
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4* wrow = reinterpret_cast<const float4*>(w_p + (k + kk) * UNITS * 4);
#pragma unroll
          for (int u = 0; u < UNITS; ++u) {
            const float4 w = wrow[u];
            acc[u][0] = fmaf(hk[kk], w.x, acc[u][0]);
            acc[u][1] = fmaf(hk[kk], w.y, acc[u][1]);
            acc[u][2] = fmaf(hk[kk], w.z, acc[u][2]);
            acc[u][3] = fmaf(hk[kk], w.w, acc[u][3]);
          }
        }
      }
      __syncthreads();  // h_s is refilled by the next pass, then reused as red_s
    }

    // 3. cross-warp reduction through shared memory
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        red_s[((warp * UNITS + u) * 4 + g) * 32 + lane] = acc[u][g];
    __syncthreads();

    // 4. gates and the masked carry for (unit u0 + cu, row cb)
    if (row_live) {
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) sum += red_s[((w * UNITS + cu) * 4 + g) * 32 + cb];
        pre[g] = sum;
      }
      float out_v = 0.0f;
      float gate_v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (t < len) {
        if (FUSED_IN) {
          const T* xrow = x + (long long)cb * a.x_sb + (long long)t * a.x_st;
          float xw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int k = 0; k < D; ++k) {
            const float xk = to_f(xrow[k]);
#pragma unroll
            for (int g = 0; g < 4; ++g) xw[g] = fmaf(xk, wih_s[(k * UNITS + cu) * 4 + g], xw[g]);
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) pre[g] = (xw[g] + b_s[cu * 4 + g]) + pre[g];
        } else {
          const T* xrow = x + (long long)d * a.x_sd + (long long)cb * a.x_sb + (long long)t * a.x_st;
#pragma unroll
          for (int g = 0; g < 4; ++g) pre[g] = to_f(xrow[g * H + u0 + cu]) + pre[g];
        }
        const float ig = sigmoidf(pre[0]);
        const float fg = sigmoidf(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoidf(pre[3]);
        c_carry = fg * c_carry + ig * gg;
        h_carry = og * tanhf(c_carry);
        out_v = h_carry;
        if (TRAIN) {
          gate_v[0] = ig, gate_v[1] = fg, gate_v[2] = gg, gate_v[3] = og;
        }
      }
      const long long o_idx =
          (long long)d * a.o_sd + (long long)cb * a.o_sb + (long long)t * a.o_st + u0 + cu;
      out[o_idx] = from_f<T>(out_v);
      if (TRAIN) {
        cs[o_idx] = from_f<T>(c_carry);
        T* grow = gates + (long long)d * a.g_sd + (long long)cb * a.g_sb +
                  (long long)t * a.g_st + u0 + cu;
#pragma unroll
        for (int g = 0; g < 4; ++g) grow[g * H] = from_f<T>(gate_v[g]);
      }
      T* h_next = hbuf + ((s + 1) & 1) * hbuf_half + (long long)d * B * H;
      h_next[(long long)cb * H + u0 + cu] = from_f<T>(h_carry);
    }
    // 5. publish h_t to every block
    grid.sync();
  }
}

static size_t smem_bytes(int D, int H, bool fused, bool wide) {
  const int hs_stride = (wide ? H / 2 : H) + 4;
  const int h_region = BMAX * hs_stride > NWARPS * UNITS * 4 * 32 ? BMAX * hs_stride
                                                                 : NWARPS * UNITS * 4 * 32;
  size_t floats = (size_t)H * UNITS * 4 + h_region;
  if (fused) floats += (size_t)D * UNITS * 4 + UNITS * 4;
  return floats * sizeof(float);
}

template <typename T, bool FUSED_IN, bool TRAIN, bool WIDE>
static cudaError_t launch(ScanArgs a, cudaStream_t stream) {
  auto kernel = lstm_scan_kernel<T, FUSED_IN, TRAIN, WIDE>;
  const size_t smem = smem_bytes(a.D, a.H, FUSED_IN, WIDE);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  const dim3 grid(a.ndir * a.H / UNITS), block(NTHREADS);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid, block, params, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Shapes are checked by the Python wrapper (ops/lstm_cuda.py): B <= 32,
// H % 32 == 0 up to 512 and H % 64 == 0 from there to 1024 (the wide form),
// ndir * H / 8 blocks no more than the card's SMs, D <= 128 for the fused
// input. A grid that still cannot be co-resident (shared memory)
// is refused by the cooperative launch and reported here.
// dtype: 0 = float32, 1 = bfloat16. train != 0 also writes cs and gates.
// Returns a cudaError_t (0 on success).
template <typename T, bool WIDE>
static cudaError_t dispatch_form(int fused, int train, ScanArgs a, cudaStream_t s) {
  if (train)
    return fused ? launch<T, true, true, WIDE>(a, s) : launch<T, false, true, WIDE>(a, s);
  return fused ? launch<T, true, false, WIDE>(a, s) : launch<T, false, false, WIDE>(a, s);
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
  if (dtype == 1) return dispatch<__nv_bfloat16>(fused, train, a, s);
  return (int)cudaErrorInvalidValue;
}
