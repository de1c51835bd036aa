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
// form's code.
//
// The geometry is its own (lstm_common.cuh's UNITS / BMAX are the float32
// adjoint's): a block owns `rows` batch rows (R) and `units` hidden units
// (U) of one direction; thread (g, u), g < R / 4, u < U, owns unit u of rows
// g, g + R / 4, g + R / 2, g + 3R / 4 (F32_RT = 4 rows, strided so that a
// warp's rows are adjacent: conflict-free float4 reads of the staged h) and
// accumulates their 4 x 4 gate columns in registers over the whole k range.
// Four rows, not two or eight: on an H100 that ran these products faster
// than two (more shared loads per FMA) or eight (too few threads to keep
// the SM's four schedulers busy).
// ops/lstm_cuda.py::plan_launches picks R, U and the ring's stages.
#pragma once

#include <stdint.h>

#include "lstm_common.cuh"
#include "wgmma_common.cuh"  // smem_u32, arrive_release, load_acquire

constexpr int F32_RT = 4;            // batch rows a thread carries
constexpr int F32_MAX_THREADS = 256;  // (R / 4) x U, at most
constexpr int F32_KC = 64;           // columns of h a ring stage holds (the last: 32 or 64)
constexpr int F32_MAX_STAGES = 4;    // ring stages, at most
constexpr int F32_PAD = 4;           // floats of padding after a staged row

__device__ __forceinline__ void f32_cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void f32_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// at most n (0 .. F32_MAX_STAGES - 1) groups still pending
__device__ __forceinline__ void f32_cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// a compile-time span of k, handed to a generic lambda
template <int V>
struct Span {
  static constexpr int value = V;
};

// shared memory of a block (ops/lstm_cuda.py::f32_smem_bytes mirrors it):
// W_hh's columns [H][U][4]; the ring, `stages` x R rows x (F32_KC + F32_PAD);
// under FUSED_IN W_ih's columns [D][U][4], the bias [U][4] and x_t's rows
// [D][R]
__host__ __device__ inline size_t f32_smem_bytes(int H, int D, int units, int rows, int stages,
                                                 bool fused) {
  size_t floats = (size_t)H * units * 4 + (size_t)stages * rows * (F32_KC + F32_PAD);
  if (fused) floats += (size_t)D * units * 4 + units * 4 + (size_t)D * rows;
  return floats * sizeof(float);
}

// a.B rows in groups of `rows`; grid (ndir x row groups x H / units) blocks,
// block (d, rg, j) = (d * RG + rg) * (H / units) + j; sync: ndir x RG zeroed
// counters, one a (direction, row group), whose H / units blocks exchange h
// through hbuf (2, ndir, RG * rows, H)
template <bool FUSED_IN, int STREAMS>
__global__ void __launch_bounds__(F32_MAX_THREADS, 1)
    lstm_scan_kernel(ScanArgs a, int units, int rows, int stages, unsigned* sync) {
  constexpr bool TRAIN = STREAMS == STREAMS_TRAIN;
  constexpr bool WITH_CS = STREAMS != STREAMS_HS;
  constexpr bool BI = STREAMS == STREAMS_BI;
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, B = a.B, seq_len = a.T, D = a.D, U = units, R = rows;
  const int blocks_per_group = H / U;
  const int n_groups = (B + R - 1) / R;
  const int group = blockIdx.x / blocks_per_group;  // d * n_groups + rg
  const int d = group / n_groups, rg = group % n_groups;
  const int u0 = (blockIdx.x % blocks_per_group) * U;
  const int r0 = rg * R;
  const bool rev = (a.rev_bits >> d) & 1;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int u = tid % U, g = tid / U;  // this thread's unit and row slot
  const int rstride = R / F32_RT;      // its rows: g + i * rstride
  constexpr int LDX = F32_KC + F32_PAD;
  const int n_chunks = (H + F32_KC - 1) / F32_KC;  // H a multiple of 32

  float* w_s = smem;
  float* ring = w_s + H * U * 4;
  float* wih_s = ring + stages * R * LDX;
  float* b_s = wih_s + D * U * 4;
  float* x_s = b_s + U * 4;

  const float* w_hh = static_cast<const float*>(a.w_hh) + (long long)d * H * 4 * H;
  for (int idx = tid; idx < H * U * 4; idx += nthreads) {
    const int k = idx / (U * 4), uu = (idx / 4) % U, gate = idx % 4;
    w_s[idx] = w_hh[(long long)k * 4 * H + gate * H + u0 + uu];
  }
  if (FUSED_IN) {
    const float* w_ih = static_cast<const float*>(a.w_ih) + (long long)d * D * 4 * H;
    const float* bias = static_cast<const float*>(a.bias) + (long long)d * 4 * H;
    for (int idx = tid; idx < D * U * 4; idx += nthreads) {
      const int k = idx / (U * 4), uu = (idx / 4) % U, gate = idx % 4;
      wih_s[idx] = w_ih[(long long)k * 4 * H + gate * H + u0 + uu];
    }
    for (int idx = tid; idx < U * 4; idx += nthreads)
      b_s[idx] = bias[(idx % 4) * H + u0 + idx / 4];
  }

  int row[F32_RT], len[F32_RT];
  bool live[F32_RT];
#pragma unroll
  for (int i = 0; i < F32_RT; ++i) {
    row[i] = r0 + g + i * rstride;
    live[i] = row[i] < B;
    len[i] = live[i] ? a.lengths[row[i]] : 0;
  }
  float h_carry[F32_RT], c_carry[F32_RT];
#pragma unroll
  for (int i = 0; i < F32_RT; ++i) h_carry[i] = c_carry[i] = 0.0f;

  const float* x = static_cast<const float*>(a.x);
  float* out = static_cast<float*>(a.out);
  float* cs = static_cast<float*>(a.cs);
  float* gates = static_cast<float*>(a.gates);
  float* hbuf = static_cast<float*>(a.hbuf);
  const long long rows_pad = (long long)n_groups * R;
  const long long hbuf_half = (long long)a.ndir * rows_pad * H;
  unsigned* ctr = sync + group;

  // the step's input term, xin[i][gate]: under FUSED_IN (x_t . W_ih + b),
  // x_t's rows staged transposed; else the x_proj entries. Computed before
  // the wait for h_{t-1}, so it overlaps the other blocks' step.
  float xin[F32_RT][4];
  auto input_term = [&](int t) {
    if (FUSED_IN) {
      __syncthreads();  // x_s is free
      for (int idx = tid; idx < R * D; idx += nthreads) {
        const int rr = idx / D, k = idx % D;
        x_s[k * R + rr] = r0 + rr < B
                              ? x[(long long)(r0 + rr) * a.x_sb + (long long)t * a.x_st + k]
                              : 0.0f;
      }
      __syncthreads();
      float xw[F32_RT][4];
#pragma unroll
      for (int i = 0; i < F32_RT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) xw[i][q] = 0.0f;
      for (int k = 0; k < D; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(wih_s + (k * U + u) * 4);
#pragma unroll
        for (int i = 0; i < F32_RT; ++i) {
          const float xk = x_s[k * R + g + i * rstride];
          xw[i][0] = fmaf(xk, w.x, xw[i][0]);
          xw[i][1] = fmaf(xk, w.y, xw[i][1]);
          xw[i][2] = fmaf(xk, w.z, xw[i][2]);
          xw[i][3] = fmaf(xk, w.w, xw[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < F32_RT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) xin[i][q] = xw[i][q] + b_s[u * 4 + q];
    } else {
#pragma unroll
      for (int i = 0; i < F32_RT; ++i) {
        const float* xrow =
            x + (long long)d * a.x_sd + (long long)row[i] * a.x_sb + (long long)t * a.x_st + u0 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) xin[i][q] = live[i] ? __ldg(xrow + q * H) : 0.0f;
      }
    }
  };
  __syncthreads();  // the weights are in shared memory
  input_term(rev ? seq_len - 1 : 0);

  for (int s = 0; s < seq_len; ++s) {
    const int t = rev ? seq_len - 1 - s : s;
    float acc[F32_RT][4];
#pragma unroll
    for (int i = 0; i < F32_RT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    if (s > 0) {  // h_{-1} = 0: no product at the first step
      // 1. wait until every block of this (direction, row group) has
      //    published h_{t-1}
      if (tid == 0) {
        const unsigned target = (unsigned)s * blocks_per_group;
        while (load_acquire(ctr) < target) {
        }
      }
      __syncthreads();
      // 2. the block's R rows of h_{t-1} stream through the ring, F32_KC
      //    columns a stage, the next stages in flight while one is multiplied
      const float* h_prev = hbuf + (s & 1) * hbuf_half + (long long)d * rows_pad * H +
                            (long long)r0 * H;
      auto issue = [&](int c) {
        float* st = ring + (c % stages) * R * LDX;
        const int pieces = min(F32_KC, H - c * F32_KC) / 4;
        for (int p = tid; p < R * pieces; p += nthreads) {
          const int rr = p / pieces, piece = p % pieces;
          f32_cp_async16(st + rr * LDX + piece * 4,
                         h_prev + (long long)rr * H + c * F32_KC + piece * 4);
        }
        f32_cp_async_commit();
      };
      // 3. the register tile: acc[i][gate] += h[row i][k] * W_hh[k][u, gate]
      //    over the chunk's span (fully unrolled)
      auto product = [&](const float* st, const float* wp, auto span) {
#pragma unroll
        for (int k = 0; k < decltype(span)::value; k += 4) {
          float4 hv[F32_RT];
#pragma unroll
          for (int i = 0; i < F32_RT; ++i)
            hv[i] = *reinterpret_cast<const float4*>(st + i * rstride * LDX + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 w = *reinterpret_cast<const float4*>(wp + (k + kk) * U * 4);
#pragma unroll
            for (int i = 0; i < F32_RT; ++i) {
              const float hk = kk == 0 ? hv[i].x : kk == 1 ? hv[i].y : kk == 2 ? hv[i].z : hv[i].w;
              acc[i][0] = fmaf(hk, w.x, acc[i][0]);
              acc[i][1] = fmaf(hk, w.y, acc[i][1]);
              acc[i][2] = fmaf(hk, w.z, acc[i][2]);
              acc[i][3] = fmaf(hk, w.w, acc[i][3]);
            }
          }
        }
      };
      for (int c = 0; c < stages && c < n_chunks; ++c) issue(c);
      for (int c = 0; c < n_chunks; ++c) {
        const int pending = min(stages, n_chunks - c) - 1;
        f32_cp_async_wait(pending);
        __syncthreads();
        const float* st = ring + (c % stages) * R * LDX + g * LDX;
        const float* wp = w_s + ((long long)c * F32_KC * U + u) * 4;
        if (H - c * F32_KC >= F32_KC)
          product(st, wp, Span<F32_KC>());
        else
          product(st, wp, Span<F32_KC / 2>());
        __syncthreads();  // the stage is read: refill it
        if (c + stages < n_chunks) issue(c + stages);
      }
    }

    // 4. gates, the masked carry and the form's stores for (row i, unit u)
    float* h_next = hbuf + ((s + 1) & 1) * hbuf_half + (long long)d * rows_pad * H;
#pragma unroll
    for (int i = 0; i < F32_RT; ++i) {
      // STREAMS_BI: direction 1's stream is flipped in time as a whole, so
      // its padded frames come first
      bool valid = t < len[i];
      if (BI) valid = d == 0 ? t < len[i] : t >= seq_len - len[i];
      float out_v = 0.0f;
      float gate_v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (valid) {
        float pre[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) pre[q] = xin[i][q] + acc[i][q];
        const float ig = sigmoidf(pre[0]);
        const float fg = sigmoidf(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoidf(pre[3]);
        c_carry[i] = fg * c_carry[i] + ig * gg;
        h_carry[i] = og * tanhf(c_carry[i]);
        out_v = h_carry[i];
        if (TRAIN) gate_v[0] = ig, gate_v[1] = fg, gate_v[2] = gg, gate_v[3] = og;
      }
      if (BI) out_v = h_carry[i];  // the carry itself, frozen at a padded frame
      if (live[i]) {
        const long long o_idx = (long long)d * a.o_sd + (long long)row[i] * a.o_sb +
                                (long long)t * a.o_st + u0 + u;
        out[o_idx] = out_v;
        if (WITH_CS) cs[o_idx] = c_carry[i];
        if (TRAIN) {
          float* grow = gates + (long long)d * a.g_sd + (long long)row[i] * a.g_sb +
                        (long long)t * a.g_st + u0 + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) grow[q * H] = gate_v[q];
        }
      }
      h_next[(long long)row[i] * H + u0 + u] = h_carry[i];  // rows past B carry 0
    }
    if (s + 1 < seq_len) {
      // 5. publish h_t to this group's blocks, then the next input term
      __syncthreads();  // the block's h_t is written
      if (tid == 0) arrive_release(ctr);
      input_term(rev ? seq_len - 2 - s : s + 1);
    }
  }
}

template <bool FUSED_IN, int STREAMS>
static cudaError_t launch(ScanArgs a, int units, int rows, int stages, unsigned* sync,
                          cudaStream_t stream) {
  auto kernel = lstm_scan_kernel<FUSED_IN, STREAMS>;
  const size_t smem = f32_smem_bytes(a.H, a.D, units, rows, stages, FUSED_IN);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  void* params[] = {&a, &units, &rows, &stages, &sync};
  const int groups = (a.B + rows - 1) / rows;
  const dim3 grid(a.ndir * groups * (a.H / units)), block(rows / F32_RT * units);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid, block, params, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The geometry this body takes (the Python plan checks it first): H a
// multiple of F32_KC / 2 and of `units`; rows a multiple of F32_RT; (rows /
// F32_RT) x units a multiple of 32 up to F32_MAX_THREADS; 1 <= stages <= F32_MAX_STAGES.
inline bool f32_geometry_ok(const ScanArgs& a, int units, int rows, int stages) {
  const int threads = units > 0 && rows > 0 ? rows / F32_RT * units : 0;
  return a.B >= 1 && a.H >= F32_KC / 2 && a.H % (F32_KC / 2) == 0 && a.H % units == 0 &&
         rows % F32_RT == 0 && threads % 32 == 0 && threads >= 32 &&
         threads <= F32_MAX_THREADS && stages >= 1 && stages <= F32_MAX_STAGES;
}
