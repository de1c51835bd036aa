// The float32 persistent LSTM recurrence kernel, shared by the two sources
// that instantiate it: lstm_scan.cu (the lean and the training forms) and
// lstm_scan_streams.cu (the hs + cs form and the fused bidirectional form).
// Two sources so that two nvcc processes build the template's instances side
// by side. lstm_scan.cu's header says what the kernel computes, what bounds
// it and how it is laid out; this file adds only the STREAMS switch. The
// bfloat16 forms run on tensor cores in lstm_scan_tc_body.cuh.
//
// STREAMS (lstm_common.cuh; compile time) names what a launch writes beside hs:
//   STREAMS_HS     nothing: the lean forms (inference, remat's first pass);
//   STREAMS_TRAIN  cs and the activated gates, for the adjoint kernel;
//   STREAMS_CS     cs alone (_lstm_scan_kernel with with_cs=True,
//                  lstm_pallas.py:98): the carry c after each frame, frozen
//                  at padded frames, in the stream dtype;
//   STREAMS_BI     cs, and hs as the carry itself (_bilstm_scan_kernel,
//                  lstm_pallas.py:1063): see lstm_scan_streams.cu.
// Every switch is a compile-time constant, so an instance holds only its own
// form's code: the STREAMS_HS and STREAMS_TRAIN instances compile to what
// they were before the other two forms existed.
#pragma once

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

template <typename T, bool FUSED_IN, int STREAMS, bool WIDE>
__global__ void __launch_bounds__(NTHREADS, 1) lstm_scan_kernel(ScanArgs a) {
  constexpr bool TRAIN = STREAMS == STREAMS_TRAIN;
  constexpr bool WITH_CS = STREAMS != STREAMS_HS;
  constexpr bool BI = STREAMS == STREAMS_BI;
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
      //    (other blocks wrote them), all in flight before any is converted.
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
      // STREAMS_BI: direction 1's stream is flipped in time as a whole, so
      // its padded frames come first
      bool valid = t < len;
      if (BI) valid = d == 0 ? t < len : t >= seq_len - len;
      if (valid) {
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
      if (BI) out_v = h_carry;  // the carry itself, frozen at a padded frame
      const long long o_idx =
          (long long)d * a.o_sd + (long long)cb * a.o_sb + (long long)t * a.o_st + u0 + cu;
      out[o_idx] = from_f<T>(out_v);
      if (WITH_CS) cs[o_idx] = from_f<T>(c_carry);
      if (TRAIN) {
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

template <typename T, bool FUSED_IN, int STREAMS, bool WIDE>
static cudaError_t launch(ScanArgs a, cudaStream_t stream) {
  auto kernel = lstm_scan_kernel<T, FUSED_IN, STREAMS, WIDE>;
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
