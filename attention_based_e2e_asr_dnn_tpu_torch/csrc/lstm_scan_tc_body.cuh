// The bfloat16 persistent LSTM recurrence on tensor cores, shared by the two
// sources that instantiate it: lstm_scan_tc.cu (the lean and the training
// forms, kernels #1, #2 and #4) and lstm_scan_tc_streams.cu (the hs + cs form
// #3 and the fused bidirectional form #7). lstm_scan_tc.cu's header says what
// bounds it and why it is laid out so; the STREAMS forms are those of the
// float32 body (lstm_common.cuh), with the same stores.
//
// Geometry. One cooperative launch takes up to TC_ROWS = 128 batch rows and
// every direction of the layer. A block owns U hidden units of one direction
// (U = 8 up to H = 512, 16 above: H / U <= 64 blocks a direction) and keeps
// their four gates' columns of W_hh, H x 4U bf16, in shared memory for the
// whole sequence, as the tensor cores' B operand: column n = 4u + g (the four
// gates of a unit side by side), 64 k-values a 128-byte row, the 16-byte
// pieces of a row XOR-swizzled by the row's low three bits (wgmma's 128-byte
// swizzle, K-major, tiles on 1024-byte boundaries). Each step:
//   1. thread 0 waits until every block of ITS direction has published
//      h_{t-1} (an acquire-polled counter in global memory: the directions
//      never wait for each other);
//   2. h_{t-1} (B x H bf16) streams through a ring of shared-memory stages of
//      64 columns in the same swizzled layout (cp.async, 16-byte pieces, L2
//      only), the next two chunks in flight while the current one is
//      multiplied (a stage holds the launch's rows rounded up to 64);
//   3. two warpgroups run wgmma.m64nNk16 (N = 4U; bf16 operands from shared
//      memory, fp32 accumulators in registers): past 64 rows each takes 64 of
//      them over all of k, up to 64 rows both take the same rows and split the
//      64-column chunks between them (rows past B are computed and dropped);
//      a chunk's products are waited for before its stage is refilled;
//   4. the k-slices' partial sums meet in a shared-memory tile (aliasing the
//      ring) and the thread of a cell adds them in the fixed order 0 .. KS-1:
//      no atomics, no k split across blocks, so every form and every run of
//      the same shape sums in the same order and repeats bit for bit;
//   5. it applies the gates, the masked carry and its form's stores exactly as
//      the float32 body does, and writes its rounded h into the other half of
//      the exchange buffer;
//   6. the block arrives on its direction's counter (release), then computes
//      the next step's input term (the x_proj entries, or under FUSED_IN the
//      15-wide input projection from W_ih in shared memory) while the other
//      blocks finish, from lines prefetched into L1 at the start of the step:
//      the input streams live in device memory, whose latency would
//      otherwise sit in every step.
// A thread owns R adjacent units of one batch row (R = U / 2 past 64 rows,
// fewer for smaller batches, so that every thread has cells), keeps their h
// and c carries in registers, and reads and writes each stream R units at a
// time.
#pragma once

#include <stdint.h>

#include "lstm_common.cuh"
#include "wgmma_common.cuh"

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_ROWS = 128;           // batch rows a launch
constexpr int TC_KC = 64;              // columns of h a ring stage holds
constexpr int TC_STAGE_BYTES = TC_ROWS * TC_KC * 2;  // a stage of 128 rows
constexpr int TC_RED_ROWS = 2 * 64;    // k-slices x row groups x 64
// stages of the ring at most: S - 2 = 2 chunks in flight. A ring that asks
// for all of h at once lands its first chunk as late as its last, where a
// shallow one lets the products start on chunk 0 while the rest loads: of 3,
// 4, 5 and 6 stages, 4 was the fastest on an H100
constexpr int TC_MAX_STAGES = 4;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// at most n groups still pending; n past 15 waits as 15 (for more: safe)
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n < 15 ? n : 15) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    case 14: cp_async_wait<14>(); break;
    default: cp_async_wait<15>(); break;
  }
}

// a compile-time count of cells, handed to a generic lambda
template <int V>
struct Cells {
  static constexpr int value = V;
};

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.L1 [%0];\n" ::"l"(p));
}

// The block's shared memory: W_hh columns, the ring (reused as the reduction
// tile), and under FUSED_IN the W_ih columns (bf16) and the bias (fp32). The
// ring takes what is left of TC_SMEM_LIMIT in whole 128-row stages, at most
// two stages more than h has chunks and TC_MAX_STAGES, at least the
// reduction tile.
__host__ __device__ constexpr int tc_red_stride(int units) { return 4 * units + 8; }
__host__ __device__ inline size_t tc_w_bytes(int H, int units) {
  return (size_t)((H + TC_KC - 1) / TC_KC) * 4 * units * 128;
}
__host__ __device__ inline size_t tc_in_bytes(int D, int units, bool fused) {
  return fused ? (size_t)D * 4 * units * 2 + 4 * units * sizeof(float) : 0;
}
__host__ __device__ inline size_t tc_ring_bytes(int D, int H, int units, bool fused) {
  const size_t red = (size_t)TC_RED_ROWS * tc_red_stride(units) * sizeof(float);
  const size_t used = TC_ALIGN + tc_w_bytes(H, units) + tc_in_bytes(D, units, fused);
  const size_t room = used < TC_SMEM_LIMIT ? (TC_SMEM_LIMIT - used) / TC_STAGE_BYTES : 0;
  const int chunks = (H + TC_KC - 1) / TC_KC;
  const size_t want = (size_t)(chunks + 2 < TC_MAX_STAGES ? chunks + 2 : TC_MAX_STAGES);
  const size_t ring = (room < want ? room : want) * TC_STAGE_BYTES;
  return ring > red ? ring : red;
}
__host__ __device__ inline size_t tc_smem_bytes(int D, int H, int units, bool fused) {
  return TC_ALIGN + tc_w_bytes(H, units) + tc_ring_bytes(D, H, units, fused) +
         tc_in_bytes(D, units, fused);
}

template <bool FUSED_IN, int STREAMS, int U>
__global__ void __launch_bounds__(TC_THREADS, 1)
    lstm_scan_tc_kernel(ScanArgs a, unsigned* sync) {
  using T = __nv_bfloat16;
  constexpr bool TRAIN = STREAMS == STREAMS_TRAIN;
  constexpr bool WITH_CS = STREAMS != STREAMS_HS;
  constexpr bool BI = STREAMS == STREAMS_BI;
  constexpr int N = 4 * U;          // gate columns of the block
  constexpr int NT = N / 8;         // n8 tiles
  constexpr int NACC = N / 2;       // a thread's accumulators of a 64 x N tile
  constexpr int UPT = U / 2;        // most units a thread takes
  constexpr int RS = tc_red_stride(U);
  extern __shared__ __align__(TC_ALIGN) unsigned char smem_raw[];

  const int H = a.H, B = a.B, seq_len = a.T, D = a.D;
  const int n_chunks = (H + TC_KC - 1) / TC_KC;
  const int blocks_per_dir = H / U;
  const int d = blockIdx.x / blocks_per_dir;
  const int u0 = (blockIdx.x % blocks_per_dir) * U;
  const bool rev = (a.rev_bits >> d) & 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the swizzled tiles start on a 1024-byte boundary of the shared window
  unsigned char* w_s =
      smem_raw + ((TC_ALIGN - (smem_u32(smem_raw) & (TC_ALIGN - 1))) & (TC_ALIGN - 1));
  unsigned char* ring = w_s + tc_w_bytes(H, U);
  float* red_s = reinterpret_cast<float*>(ring);
  const int ring_bytes = (int)tc_ring_bytes(D, H, U, FUSED_IN);
  T* wih_s = reinterpret_cast<T*>(ring + ring_bytes);
  float* b_s = reinterpret_cast<float*>(wih_s + D * N);

  // W_hh columns [u0, u0 + U) of each gate, k past H zero
  const T* w_hh = static_cast<const T*>(a.w_hh) + (long long)d * H * 4 * H;
  for (int idx = tid; idx < n_chunks * TC_KC * N; idx += TC_THREADS) {
    const int n = idx % N, k = idx / N;
    const T v = k < H ? w_hh[(long long)k * 4 * H + (n & 3) * H + u0 + (n >> 2)]
                      : __float2bfloat16(0.0f);
    const int kk = k % TC_KC;
    *reinterpret_cast<T*>(w_s + (k / TC_KC) * N * 128 + swz(n, kk >> 3) + (kk & 7) * 2) = v;
  }
  if (FUSED_IN) {
    const T* w_ih = static_cast<const T*>(a.w_ih) + (long long)d * D * 4 * H;
    const T* bias = static_cast<const T*>(a.bias) + (long long)d * 4 * H;
    for (int idx = tid; idx < D * N; idx += TC_THREADS) {
      const int n = idx % N, k = idx / N;
      wih_s[idx] = w_ih[(long long)k * 4 * H + (n & 3) * H + u0 + (n >> 2)];
    }
    if (tid < N) b_s[tid] = to_f(bias[(tid & 3) * H + u0 + (tid >> 2)]);
  }

  // this thread's cells: R adjacent units [ub, ub + R) of batch row `row`,
  // their h and c carries in registers. R shrinks with the batch (U / 2 past
  // 64 rows, U / 4 past 32, else U / 8 or 1) so that the B x U cells spread
  // over all 256 threads, each still read and written R at a time.
  const int R = B > 64 ? UPT : (B > 32 ? UPT / 2 : (UPT >= 4 ? UPT / 4 : 1));
  const int row = tid / (U / R), ub = (tid % (U / R)) * R;
  const bool row_live = row < B;
  const int len = row_live ? a.lengths[row] : 0;
  float h_carry[UPT], c_carry[UPT], xin[UPT][4];
#pragma unroll
  for (int i = 0; i < UPT; ++i) h_carry[i] = 0.0f, c_carry[i] = 0.0f;
  // run(Cells<R>) with this launch's R as a compile-time count
  auto with_cells = [&](auto run) {
    if (R == UPT)
      run(Cells<UPT>{});
    else if (R == UPT / 2)
      run(Cells<UPT / 2>{});
    else
      run(Cells<(UPT >= 4 ? UPT / 4 : 1)>{});
  };

  // the warpgroup's share of the dot: up to 64 rows, one warpgroup a 64-row
  // group and the k-chunks split between the two (KS = 2) or, past 64 rows,
  // a group each over all of k (KS = 1)
  const int RG = B > 64 ? 2 : 1;
  const int KS = 2 / RG;
  const int wg = warp / 4;
  const int rg = wg % RG, ks = wg / RG;
  // the ring: S stages of the launch's rows rounded up to 64, S - 2 in flight
  // (a stage is refilled two chunks after it was read: the products of the
  // chunk before it may still be running)
  const int stage_bytes = RG * 64 * 128;
  const int S = min(min(n_chunks + 2, ring_bytes / stage_bytes), TC_MAX_STAGES);

  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  T* cs = static_cast<T*>(a.cs);
  T* gates = static_cast<T*>(a.gates);
  T* hbuf = static_cast<T*>(a.hbuf);
  const long long hbuf_half = (long long)a.ndir * B * H;

  // BI: direction 1's stream is flipped in time as a whole, so its padded
  // frames come first
  auto frame_valid = [&](int t) {
    if (BI) return d == 0 ? t < len : t >= seq_len - len;
    return t < len;
  };
  // what the input term of step s reads: the row's x_proj entries of gate 0
  // (the others H apart), or under FUSED_IN its input frame. A row past B
  // reads row B - 1 and its term goes unused.
  auto x_at = [&](int s) {
    const int t = rev ? seq_len - 1 - s : s;
    const T* p = x + (long long)min(row, B - 1) * a.x_sb + (long long)t * a.x_st;
    return FUSED_IN ? p : p + (long long)d * a.x_sd + u0 + ub;
  };
  // the input term of step s: x_proj's entries, or the fused input projection
  // (x_t @ W_ih + b), summed over k in order as the float32 body sums it
  auto input_term = [&](int s) {
    const T* p = x_at(s);
    with_cells([&](auto cells) {
      constexpr int RC = decltype(cells)::value;
      if (FUSED_IN) {
#pragma unroll
        for (int i = 0; i < RC; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g) xin[i][g] = 0.0f;
        for (int k = 0; k < D; ++k) {
          const float xk = to_f(p[k]);
          float w[4 * RC];  // W_ih's row k for the thread's units, n = 4u + g
          constexpr int PIECE = 4 * RC < 8 ? 4 * RC : 8;
#pragma unroll
          for (int q = 0; q < 4 * RC; q += PIECE)
            load_bf16<PIECE>(wih_s + k * N + 4 * ub + q, w + q);
#pragma unroll
          for (int i = 0; i < RC; ++i)
#pragma unroll
            for (int g = 0; g < 4; ++g) xin[i][g] = fmaf(xk, w[4 * i + g], xin[i][g]);
        }
#pragma unroll
        for (int i = 0; i < RC; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g) xin[i][g] = xin[i][g] + b_s[4 * (ub + i) + g];
      } else {
        float v[4][RC];
#pragma unroll
        for (int g = 0; g < 4; ++g) load_bf16<RC>(p + g * H, v[g]);
#pragma unroll
        for (int i = 0; i < RC; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g) xin[i][g] = v[g][i];
      }
    });
  };
  // bring step s's input lines into L1 while the step before runs
  auto prefetch_input = [&](int s) {
    const T* p = x_at(s);
    if (FUSED_IN) {
      prefetch_l1(p);
      prefetch_l1(p + D - 1);
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g) prefetch_l1(p + g * H);
    }
  };
  __syncthreads();  // the weights are in shared memory
  input_term(0);

  const uint32_t w_addr = smem_u32(w_s), ring_addr = smem_u32(ring);
  for (int s = 0; s < seq_len; ++s) {
    const int t = rev ? seq_len - 1 - s : s;
    if (s + 1 < seq_len) prefetch_input(s + 1);
    if (s > 0) {
      // 1. wait for this direction's h_{t-1}
      if (tid == 0) {
        const unsigned target = (unsigned)s * blocks_per_dir;
        while (load_acquire(sync + d) < target) {
        }
      }
      __syncthreads();
      const T* h_prev = hbuf + (s & 1) * hbuf_half + (long long)d * B * H;
      auto issue = [&](int c) {
        const uint32_t stage = ring_addr + (c % S) * stage_bytes;
        for (int p = tid; p < B * 8; p += TC_THREADS) {
          const int row = p >> 3, piece = p & 7, col = c * TC_KC + piece * 8;
          if (col < H) cp_async16(stage + swz(row, piece), h_prev + (long long)row * H + col);
        }
      };
      // 2-3. the ring and the products
      float acc[NACC];
#pragma unroll
      for (int e = 0; e < NACC; ++e) acc[e] = 0.0f;
      for (int c = 0; c < S - 2; ++c) {
        if (c < n_chunks) issue(c);
        cp_async_commit();
      }
      for (int c = 0; c < n_chunks; ++c) {
        cp_async_wait_pending(S - 3);
        fence_proxy_async();  // chunk c, written by cp.async, is read by wgmma
        // chunk c - 2's products are done: the most recent group of this
        // warpgroup may stay in flight only if it is chunk c - 1's
        if ((c - 1) % KS == ks)
          wgmma_wait<1>(acc);
        else
          wgmma_wait<0>(acc);
        __syncthreads();  // chunk c has landed for all; chunk c - 2 is consumed
        if (c + S - 2 < n_chunks) issue(c + S - 2);
        cp_async_commit();
        if (c % KS == ks) {
          const uint32_t a_tile = ring_addr + (c % S) * stage_bytes + rg * 64 * 128;
          const uint32_t b_tile = w_addr + c * N * 128;
          const int ksteps = min(TC_KC, H - c * TC_KC) / 16;
          wgmma_fence();
          for (int kk = 0; kk < ksteps; ++kk)
            wgmma_bf16<N>(acc, sw128_desc(a_tile + kk * 32), sw128_desc(b_tile + kk * 32));
          wgmma_commit();
        }
      }
      wgmma_wait<0>(acc);
      __syncthreads();  // every warpgroup is done with the ring: it becomes red_s
      // 4. the k-slices' partial sums into the tile [ks][row][n]: warp w of a
      //    warpgroup holds rows 16 (w % 4) + lane / 4 (+ 8) of its 64
      {
        float* red = red_s + (long long)(ks * RG + rg) * 64 * RS;
        const int r = (warp % 4) * 16 + (lane >> 2);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = n * 8 + (lane & 3) * 2;
          *reinterpret_cast<float2*>(red + r * RS + col) = make_float2(acc[4 * n], acc[4 * n + 1]);
          *reinterpret_cast<float2*>(red + (r + 8) * RS + col) =
              make_float2(acc[4 * n + 2], acc[4 * n + 3]);
        }
      }
      __syncthreads();
    }

    // 5. gates, the masked carry and the stores of the thread's cells
    T* h_next = hbuf + ((s + 1) & 1) * hbuf_half + (long long)d * B * H;
    if (row_live) with_cells([&](auto cells) {
      constexpr int RC = decltype(cells)::value;
      const bool valid = frame_valid(t);
      float out_v[RC], gate_v[4][RC];
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        out_v[i] = 0.0f;
#pragma unroll
        for (int g = 0; g < 4; ++g) gate_v[g][i] = 0.0f;
        if (valid) {
          float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (s > 0) {
            for (int q = 0; q < KS; ++q) {
              const float4 p = *reinterpret_cast<const float4*>(
                  red_s + ((long long)q * RG * 64 + row) * RS + 4 * (ub + i));
              dot[0] += p.x, dot[1] += p.y, dot[2] += p.z, dot[3] += p.w;
            }
          }
          float pre[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) pre[g] = xin[i][g] + dot[g];
          const float ig = sigmoidf(pre[0]);
          const float fg = sigmoidf(pre[1]);
          const float gg = tanhf(pre[2]);
          const float og = sigmoidf(pre[3]);
          c_carry[i] = fg * c_carry[i] + ig * gg;
          h_carry[i] = og * tanhf(c_carry[i]);
          out_v[i] = h_carry[i];
          if (TRAIN) {
            gate_v[0][i] = ig, gate_v[1][i] = fg, gate_v[2][i] = gg, gate_v[3][i] = og;
          }
        }
        if (BI) out_v[i] = h_carry[i];  // the carry itself, frozen at a padded frame
      }
      const long long o_idx =
          (long long)d * a.o_sd + (long long)row * a.o_sb + (long long)t * a.o_st + u0 + ub;
      store_bf16<RC>(out + o_idx, out_v);
      if (WITH_CS) store_bf16<RC>(cs + o_idx, c_carry);
      if (TRAIN) {
        T* grow = gates + (long long)d * a.g_sd + (long long)row * a.g_sb +
                  (long long)t * a.g_st + u0 + ub;
#pragma unroll
        for (int g = 0; g < 4; ++g) store_bf16<RC>(grow + g * H, gate_v[g]);
      }
      store_bf16<RC>(h_next + (long long)row * H + u0 + ub, h_carry);
    });
    if (s + 1 < seq_len) {
      // 6. publish h_t to this direction's blocks, then the next input term
      __syncthreads();  // the block's h_t is written and red_s is read
      if (tid == 0) arrive_release(sync + d);
      input_term(s + 1);
    }
  }
}

template <bool FUSED_IN, int STREAMS, int U>
static cudaError_t tc_launch(ScanArgs a, unsigned* sync, cudaStream_t stream) {
  auto kernel = lstm_scan_tc_kernel<FUSED_IN, STREAMS, U>;
  const size_t smem = tc_smem_bytes(a.D, a.H, U, FUSED_IN);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* params[] = {&a, &sync};
  const dim3 grid(a.ndir * a.H / U), block(TC_THREADS);
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid, block, params, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The shapes this body takes (the Python plan checks them first): 1 <= B <=
// TC_ROWS; H a multiple of 32 up to 512 and of 64 up to 1024; U = 8 or 16
// dividing H; D <= 128 under FUSED_IN.
template <bool FUSED_IN, int STREAMS>
static cudaError_t tc_dispatch(int units, ScanArgs a, unsigned* sync, cudaStream_t s) {
  const bool shape_ok = a.B >= 1 && a.B <= TC_ROWS && a.H >= 32 && a.H % 32 == 0 &&
                        a.H <= 1024 && (a.H <= 512 || a.H % 64 == 0) && a.H % units == 0 &&
                        (!FUSED_IN || (a.D >= 1 && a.D <= 128));
  if (!shape_ok) return cudaErrorInvalidValue;
  if (units == 8) return tc_launch<FUSED_IN, STREAMS, 8>(a, sync, s);
  if (units == 16) return tc_launch<FUSED_IN, STREAMS, 16>(a, sync, s);
  return cudaErrorInvalidValue;
}
