// Adjoint of the persistent LSTM recurrence (lstm_scan.cu, TRAIN = true) for
// Hopper (sm_90a), float32: one cooperative launch walks the whole time loop
// of one listener layer backwards, one or both directions (bfloat16 is
// lstm_bwd_tc.cu's, on tensor cores). Two forms of one kernel:
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py), in float32:
//   WITH_DW = true, entry lstm_bwd_dw: _lstm_bwd_dw_kernel (:382), launched by
//       _backward_pallas_dw (:593), the H <= 512 route of _adjoint_with_dw
//       (:788), which also accumulates dW_hh;
//   WITH_DW = false, entry lstm_bwd: _lstm_bwd_kernel (:311), launched by
//       _backward_pallas (:668), the route of wider layers (H = 1024): it
//       returns dpre only, and dW_hh is one product over the streamed hs and
//       dpre outside the kernel (ops/lstm_cuda.py), as in the JAX package.
//
// What it computes. Time runs opposite to the forward scan. With the saved
// activated gates i, f, g, o, the saved carry c_t, its scan-previous value
// c_prev (cs one frame earlier along the scan, zero at the scan's first
// frame: cs is indexed, the shift is never materialised), the output
// gradient dy and m = (t < length):
//   dh_total = dy * m + dh
//   dc_total = dc + dh_total * o * (1 - tanh(c_t)^2)
//   dpre = [dc_total*g*i*(1-i), dc_total*c_prev*f*(1-f),
//           dc_total*i*(1-g^2), dh_total*tanh(c_t)*o*(1-o)] * m
//   dh_prev = round(dpre) @ W_hh^T,  dc_prev = dc_total * f
//   dh = m ? dh_prev : dh_total,     dc = m ? dc_prev : dc
//   dW_hh += hs[scan-previous frame]^T round(dpre)      (WITH_DW only)
// dpre is stored in the stream dtype; the rounded values are the operands of
// both products, sums are fp32, carries fp32. A padded frame is an exact
// no-op (dpre = 0, carries unchanged). The scan's first frame pairs with
// h = 0 and adds nothing to dW_hh.
//
// What bounds it: as the forward, every step waits for the previous step's
// result from every block, so a layer costs T x (one grid-wide barrier +
// reading the previous dpre (B x 4H) from L2 + this block's share of the
// (B, 4H) x (4H, H) product + its share of the dW_hh update + the gate
// math). Latency-bound; per block and step it reads four times the forward's
// exchange bytes and does twice its FMAs (PERF.md has the measured times).
//
// Design. The forward's persistent grid: ndir * H / UNITS blocks, block j of
// direction d owns hidden units [UNITS*j, UNITS*j + UNITS) and keeps their
// ROWS of W_hh (UNITS x 4H, fp32) in shared memory. Thread (warp u, lane b)
// owns batch row b of unit u and keeps its dh, dc in registers. Each step:
//   0. thread (u, b) issues the loads of its saved values at this frame;
//   1. (not at the first step) dh_prev: the previous step's dpre is staged
//      from the dpre output, which doubles as the exchange buffer, one gate
//      (B x H) at a time; warp w takes k in [w*H/8, (w+1)*H/8) of each gate
//      for its lane's row and all UNITS units (8 fp32 accumulators); the
//      partials are summed across warps through shared memory;
//   2. thread (u, b) forms its four dpre, stores them (rounded) to the output
//      and to shared memory, and updates dc;
//   3. dW_hh: the block owns the 4 * UNITS gate columns of its units, whose
//      dpre never leave the block; hs at the scan-previous frame (an input)
//      is staged into shared memory and thread (hq, ch) adds
//      hs[b, 4hq..4hq+3] x dpre[b, 16ch..16ch+15] over the rows into 64 fp32
//      registers, written out once after the last step;
//   4. one grid-wide barrier publishes dpre_t.
// Plain FMA on the CUDA cores, which keep float32's tolerance.
//
// The form without dW_hh drops step 3, the hs input, the 64 accumulators and
// the block's own-dpre buffer. What is hard at H = 1024 and what it does:
//   * shared memory: the block's rows of W_hh take UNITS x 4H x 4 bytes
//     (128 KB), and one gate (B x H fp32, 131 KB) no longer fits beside them.
//     The previous dpre row (4H wide) is therefore staged in pieces of
//     SW = H / 2 columns (8 passes of 66 KB), 202 KB a block in all, the same
//     for both dtypes since shared memory holds fp32. Up to H = 512 a piece is
//     one gate (SW = H, 4 passes), as in the form with dW_hh;
//   * grid: 2 x 1024 / 8 = 256 blocks cannot be co-resident at one block an
//     SM, and two blocks an SM would halve the shared memory. The wrapper
//     launches once a direction (128 blocks): the directions are independent,
//     and the JAX package launches once a direction too (:1252);
//   * c_prev is cs indexed one frame earlier along the scan, zero at the
//     scan's first frame; no shifted copy is made.
// Per block and step it reads the previous dpre (B x 4H) from L2 and does
// B x 4H x UNITS FMAs, at H = 1024 twice what it does at H = 512.

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

constexpr int DW_H = 4;      // hidden rows of dW_hh per thread
constexpr int DW_COLS = 16;  // gate columns of dW_hh per thread (of 4 * UNITS)
constexpr int OWN_COLS = 4 * UNITS;

struct BwdArgs {
  const void* gates;   // (B, T, ndir*4H) activated gates, stream dtype
  const void* cs;      // (B, T, ndir*H) carry c after each frame
  const void* hs;      // (B, T, ndir*H) forward outputs, zero at pads
  const void* dy;      // (B, T, ndir*H) gradient of hs
  const void* w_hh;    // (ndir, H, 4H)
  const int* lengths;  // (B,)
  void* dpre;          // out (B, T, ndir*4H), stream dtype; the exchange buffer
  float* dw;           // out (ndir, H, 4H) fp32
  int ndir, rev_bits, B, T, H;  // ndir: directions side by side in the tensors
  int dir0, grid_dirs;          // this launch runs directions [dir0, dir0 + grid_dirs)
};

template <typename T, bool WITH_DW>
__global__ void __launch_bounds__(NTHREADS, 1) lstm_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, B = a.B, seq_len = a.T;
  const int G = 4 * H;
  const int blocks_per_dir = H / UNITS;
  const int d = a.dir0 + blockIdx.x / blocks_per_dir;
  const int u0 = (blockIdx.x % blocks_per_dir) * UNITS;
  const bool rev = (a.rev_bits >> d) & 1;  // the forward scan walked time descending
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // columns of the previous dpre row staged at a time: one gate, or half a
  // gate for a wide layer in the form without dW_hh
  const int SW = (!WITH_DW && H > WIDE_FROM) ? H / 2 : H;
  const int n_pass = WITH_DW ? 4 : G / SW;
  const int st_stride = SW + 4;  // padded rows: conflict-free float4 reads

  // shared memory: W_hh rows [4H][UNITS]; staging [BMAX][SW + 4]; cross-warp
  // reduction [NWARPS][UNITS][32]; WITH_DW: this block's own dpre
  // [BMAX][4 * UNITS]
  float* w_s = smem;
  float* stage_s = w_s + G * UNITS;
  float* red_s = stage_s + BMAX * st_stride;
  float* own_s = red_s + NWARPS * UNITS * 32;

  const T* w_hh = static_cast<const T*>(a.w_hh) + (long long)d * H * G;
  for (int idx = threadIdx.x; idx < G * UNITS; idx += NTHREADS) {
    const int u = idx / G, k = idx % G;
    w_s[k * UNITS + u] = to_f(w_hh[(long long)(u0 + u) * G + k]);
  }

  // the cell thread: unit u0 + warp, batch row lane
  const int cu = warp, cb = lane;
  const bool row_live = cb < B;
  const int len = row_live ? a.lengths[cb] : 0;
  float dh = 0.0f, dc = 0.0f;
  bool m_last = false;  // whether the adjoint's previous step was a valid frame

  // contiguous (B, T, ndir*H) and (B, T, ndir*4H) tensors
  const long long sb_h = (long long)seq_len * a.ndir * H, st_h = (long long)a.ndir * H;
  const long long sb_g = (long long)seq_len * a.ndir * G, st_g = (long long)a.ndir * G;
  const T* gates = static_cast<const T*>(a.gates) + (long long)d * G;
  const T* cs = static_cast<const T*>(a.cs) + (long long)d * H;
  const T* hs = static_cast<const T*>(a.hs) + (long long)d * H;
  const T* dy = static_cast<const T*>(a.dy) + (long long)d * H;
  T* dpre = static_cast<T*>(a.dpre) + (long long)d * G;

  // the dW thread: hidden rows [DW_H*hq, DW_H*hq + DW_H), own columns
  // [DW_COLS*ch, DW_COLS*ch + DW_COLS) in the order (unit, gate)
  const int hq = threadIdx.x >> 1, ch = threadIdx.x & 1;
  const bool dw_live = hq * DW_H < H;
  float acc_dw[DW_H][DW_COLS];
#pragma unroll
  for (int i = 0; i < DW_H; ++i)
#pragma unroll
    for (int c = 0; c < DW_COLS; ++c) acc_dw[i][c] = 0.0f;

  const int k_per_warp = SW / NWARPS;  // of each staged piece's columns
  const int kk0 = warp * k_per_warp;
  cg::grid_group grid = cg::this_grid();
  __syncthreads();

  for (int s = 0; s < seq_len; ++s) {
    const int t = rev ? s : seq_len - 1 - s;
    const bool has_prev = rev ? (t + 1 < seq_len) : (t > 0);
    const int t_prev = rev ? t + 1 : t - 1;  // the forward scan's previous frame
    const int t_last = rev ? t - 1 : t + 1;  // the adjoint's previous step
    const bool valid = row_live && t < len;

    // 0. this frame's saved values (independent of the recurrence)
    float gi = 0.0f, gf = 0.0f, gg = 0.0f, go = 0.0f, c_t = 0.0f, c_p = 0.0f, dy_v = 0.0f;
    if (valid) {
      const long long off_h = (long long)cb * sb_h + (long long)t * st_h + u0 + cu;
      const T* grow = gates + (long long)cb * sb_g + (long long)t * st_g + u0 + cu;
      gi = to_f(grow[0]);
      gf = to_f(grow[H]);
      gg = to_f(grow[2 * H]);
      go = to_f(grow[3 * H]);
      c_t = to_f(cs[off_h]);
      dy_v = to_f(dy[off_h]);
      if (has_prev) c_p = to_f(cs[(long long)cb * sb_h + (long long)t_prev * st_h + u0 + cu]);
    }

    // 1. dh_prev of the adjoint's previous step: dpre[t_last] @ W_hh^T
    if (s > 0) {
      float acc[UNITS];
#pragma unroll
      for (int u = 0; u < UNITS; ++u) acc[u] = 0.0f;
      for (int c = 0; c < n_pass; ++c) {
        stage_rows(stage_s, st_stride, dpre + (long long)t_last * st_g + c * SW, sb_g, B, SW);
        __syncthreads();
        const float* drow = stage_s + lane * st_stride;
        const float* wc = w_s + (long long)c * SW * UNITS;
        for (int kk = kk0; kk < kk0 + k_per_warp; kk += 4) {
          const float4 dv = *reinterpret_cast<const float4*>(drow + kk);
          const float dk[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4* wr = reinterpret_cast<const float4*>(wc + (kk + j) * UNITS);
            const float4 w0 = wr[0], w1 = wr[1];
            acc[0] = fmaf(dk[j], w0.x, acc[0]);
            acc[1] = fmaf(dk[j], w0.y, acc[1]);
            acc[2] = fmaf(dk[j], w0.z, acc[2]);
            acc[3] = fmaf(dk[j], w0.w, acc[3]);
            acc[4] = fmaf(dk[j], w1.x, acc[4]);
            acc[5] = fmaf(dk[j], w1.y, acc[5]);
            acc[6] = fmaf(dk[j], w1.z, acc[6]);
            acc[7] = fmaf(dk[j], w1.w, acc[7]);
          }
        }
        __syncthreads();  // stage_s is refilled by the next piece
      }
#pragma unroll
      for (int u = 0; u < UNITS; ++u) red_s[(warp * UNITS + u) * 32 + lane] = acc[u];
      __syncthreads();
      if (m_last) {  // a padded frame leaves dh as it was
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) sum += red_s[(w * UNITS + cu) * 32 + cb];
        dh = sum;
      }
    }

    // 2. this frame's dpre and the dc carry for (unit u0 + cu, row cb)
    float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (valid) {
      const float tanh_ct = tanhf(c_t);
      const float dh_total = dy_v + dh;
      const float dc_total = dc + dh_total * go * (1.0f - tanh_ct * tanh_ct);
      dp[0] = dc_total * gg * gi * (1.0f - gi);
      dp[1] = dc_total * c_p * gf * (1.0f - gf);
      dp[2] = dc_total * gi * (1.0f - gg * gg);
      dp[3] = dh_total * tanh_ct * go * (1.0f - go);
      dc = dc_total * gf;  // dh is replaced by dh_prev at the next step
    }
    m_last = valid;
    if (row_live) {
      T* prow = dpre + (long long)cb * sb_g + (long long)t * st_g + u0 + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const T r = from_f<T>(dp[g]);
        prow[g * H] = r;
        if (WITH_DW) own_s[cb * OWN_COLS + cu * 4 + g] = to_f(r);
      }
    }

    // 3. dW_hh += hs[t_prev]^T dpre_t for this block's columns
    if (WITH_DW && has_prev) {
      stage_rows(stage_s, st_stride, hs + (long long)t_prev * st_h, sb_h, B, H);
      __syncthreads();  // also publishes own_s
      if (dw_live) {
        for (int b = 0; b < B; ++b) {
          const float4 hv = *reinterpret_cast<const float4*>(stage_s + b * st_stride + hq * DW_H);
          const float hk[DW_H] = {hv.x, hv.y, hv.z, hv.w};
          const float4* dvp = reinterpret_cast<const float4*>(own_s + b * OWN_COLS + ch * DW_COLS);
#pragma unroll
          for (int q = 0; q < DW_COLS / 4; ++q) {
            const float4 dv = dvp[q];
#pragma unroll
            for (int i = 0; i < DW_H; ++i) {
              acc_dw[i][q * 4 + 0] = fmaf(hk[i], dv.x, acc_dw[i][q * 4 + 0]);
              acc_dw[i][q * 4 + 1] = fmaf(hk[i], dv.y, acc_dw[i][q * 4 + 1]);
              acc_dw[i][q * 4 + 2] = fmaf(hk[i], dv.z, acc_dw[i][q * 4 + 2]);
              acc_dw[i][q * 4 + 3] = fmaf(hk[i], dv.w, acc_dw[i][q * 4 + 3]);
            }
          }
        }
      }
    }
    // 4. publish dpre_t to every block (and fence the shared buffers' reuse)
    grid.sync();
  }

  if (WITH_DW && dw_live) {
    float* dw = a.dw + (long long)d * H * G;
#pragma unroll
    for (int i = 0; i < DW_H; ++i)
#pragma unroll
      for (int c = 0; c < DW_COLS; ++c) {
        const int col = ch * DW_COLS + c;  // (unit, gate) within the block
        dw[(long long)(hq * DW_H + i) * G + (col % 4) * H + u0 + col / 4] = acc_dw[i][c];
      }
  }
}

static size_t smem_bytes(int H, bool with_dw) {
  const int sw = (!with_dw && H > WIDE_FROM) ? H / 2 : H;
  const size_t floats = (size_t)4 * H * UNITS + (size_t)BMAX * (sw + 4) +
                        (size_t)NWARPS * UNITS * 32 + (with_dw ? (size_t)BMAX * OWN_COLS : 0);
  return floats * sizeof(float);
}

template <typename T, bool WITH_DW>
static cudaError_t launch(BwdArgs a, cudaStream_t stream) {
  auto kernel = lstm_bwd_kernel<T, WITH_DW>;
  const size_t smem = smem_bytes(a.H, WITH_DW);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  const dim3 grid(a.grid_dirs * a.H / UNITS), block(NTHREADS);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid, block, params, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Shapes are checked by the Python wrapper (ops/lstm_cuda.py): B <= 32,
// H % 32 == 0, H <= 512, ndir * H / 8 blocks no more than the card's SMs,
// every tensor contiguous. dtype: 0 = float32 (bfloat16 is lstm_bwd_tc_launch's). Returns a
// cudaError_t (0 on success).
extern "C" int lstm_bwd_dw_launch(int dtype, int ndir, int rev_bits, int B, int T, int H,
                                  const void* gates, const void* cs, const void* hs,
                                  const void* dy, const void* w_hh, const int* lengths,
                                  void* dpre, float* dw, void* stream) {
  BwdArgs a{gates, cs, hs, dy, w_hh, lengths, dpre, dw, ndir, rev_bits, B, T, H, 0, ndir};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, true>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The form without dW_hh: no hs, no dw. The tensors hold ndir directions side
// by side; the launch runs grid_dirs of them from dir0 on. H % 32 == 0 up to
// 512 and H % 64 == 0 from there to 1024; grid_dirs * H / 8 blocks no more
// than the card's SMs (the wrapper launches a wide layer once a direction).
extern "C" int lstm_bwd_launch(int dtype, int ndir, int rev_bits, int dir0, int grid_dirs, int B,
                               int T, int H, const void* gates, const void* cs, const void* dy,
                               const void* w_hh, const int* lengths, void* dpre,
                               void* stream) {
  BwdArgs a{gates, cs,   nullptr,  dy, w_hh, lengths, dpre,
            nullptr, ndir, rev_bits, B,  T,    H,       dir0, grid_dirs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, false>(a, s);
  return (int)cudaErrorInvalidValue;
}
