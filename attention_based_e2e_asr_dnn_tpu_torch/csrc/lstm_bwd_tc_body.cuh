// The bfloat16 adjoint of the LSTM recurrence on tensor cores, instantiated by
// lstm_bwd_tc.cu (whose header says what it replaces, what bounds it and why
// it is laid out so). What it computes is lstm_bwd.cu's, term for term.
//
// Geometry. One cooperative launch takes up to BT_ROWS = 128 batch rows and
// every direction of the layer. A block owns U hidden units of one direction
// (U = 8 up to H = 512, 16 above: H / U <= 64 blocks a direction) and keeps
// their ROWS of W_hh, U x 4H bf16, in shared memory for the whole sequence as
// the tensor cores' B operand (K-major: unit n's 4H values, 64 a 128-byte
// row, the 128-byte swizzle, one U-row tile per 64 k). 288 threads: two
// consumer warpgroups and a producer warp. Each step s (frame t):
//   0. the consumers load this frame's saved gates, c_t, c_prev and dy of
//      their cells into registers (and, WITH_DW, hs_t's U columns into a
//      K-major swizzled tile), independent of the recurrence;
//   1. the producer's lane 0 waits until every block of ITS direction has
//      published dpre_{t_last} (an acquire-polled counter: the directions
//      never wait for each other), then streams dpre_{t_last} (rows x 4H of
//      the exchange buffer) through a ring of stages of 128 columns, each two
//      64-column TMA boxes with the 128-byte swizzle, completing on the
//      stage's `full` mbarrier;
//   2. the consumers wait on `full`, run wgmma.m64nUk16 (bf16 operands from
//      shared memory, fp32 accumulators): past 64 rows each warpgroup takes
//      64 rows over all k, up to 64 rows both take the same rows and each one
//      box of every stage, summed in a shared tile in the fixed order
//      warpgroup 0 + warpgroup 1. WITH_DW, warpgroup w then adds box w's
//      dW^T tile: dW^T[cols, own units] += dpre_box^T (M-major A, the same
//      stage) . hs_t (B = rows), into accumulators it keeps in registers for
//      the whole sequence, in the same commit group. A stage's products are
//      waited for one chunk later and the stage released through its `empty`
//      mbarrier (one arrival a consumer warp); no block-wide barrier a chunk;
//   3. the cell epilogue: a thread's cells are the accumulators it holds
//      (rows 16 (warp % 4) + lane / 4 (+ 8), units 8 j + 2 (lane % 4) (+ 1)),
//      dh and dc carried in registers; the rounded dpre is stored to the
//      output and to the exchange buffer's half of this step;
//   4. one named barrier of the consumers, then one thread arrives on the
//      direction's counter (release).
// No atomics and no k split across blocks: two calls repeat bit for bit, and
// the form WITH_DW gives the same dpre as the form without (the dW products
// never touch dh's accumulators).
#pragma once

#include <cuda.h>  // CUtensorMap (the entry point is reached through the runtime)

#include "lstm_common.cuh"
#include "wgmma_common.cuh"

constexpr int BT_CONSUMERS = 256;                // two warpgroups
constexpr int BT_THREADS = BT_CONSUMERS + 32;    // and the producer warp
constexpr int BT_ROWS = 128;                     // batch rows a launch
constexpr int BT_SC = 128;                       // columns of dpre a ring stage holds
constexpr int BT_MAX_STAGES = 6;
constexpr int BT_DW_TILES = 4 * 512 / BT_SC;     // stages a step at H = 512: dW tiles a warpgroup
constexpr int BT_BAR_BYTES = 2 * BT_MAX_STAGES * 8;

struct BwdTcArgs {
  const void* gates;   // (B, T, ndir*4H) activated gates
  const void* cs;      // (B, T, ndir*H) carry c after each frame
  const void* hs;      // (B, T, ndir*H) forward outputs, zero at pads (WITH_DW)
  const void* dy;      // (B, T, ndir*H) gradient of hs
  const void* w_hh;    // (ndir, H, 4H)
  const int* lengths;  // (B,)
  void* dpre;          // out (B, T, ndir*4H)
  void* xbuf;          // (2, launch directions, B, 4H) the exchange, read by TMA
  float* dw;           // out (ndir, H, 4H) fp32 (WITH_DW)
  int ndir, rev_bits, B, T, H;  // ndir: directions side by side in the tensors
  int dir0;                     // the launch runs directions [dir0, dir0 + gridDim.x * U / H)
};

// The block's shared memory, in this order: W_hh rows (U x 4H bf16); the
// ring, whole stages of the launch's rows rounded up to 64 (64 or 128) x 128
// columns, at most BT_MAX_STAGES and at most the stages of one step; WITH_DW
// the hs_t tile (rows x U bf16); up to 64 rows the reduction tile (64 x U
// fp32); the mbarriers. Everything from the ring on fills what W_hh leaves of
// TC_SMEM_LIMIT, after the slack that puts the tiles on a 1024-byte boundary.
__host__ __device__ inline int bt_box_rows(int B) { return B > 64 ? 128 : 64; }
__host__ __device__ inline size_t bt_w_bytes(int H, int U) { return (size_t)(4 * H / 64) * U * 128; }
__host__ __device__ inline size_t bt_stage_bytes(int B) { return (size_t)bt_box_rows(B) * BT_SC * 2; }
__host__ __device__ inline size_t bt_hs_bytes(int B, int U, bool dw) {
  return dw ? (size_t)(bt_box_rows(B) / 64) * U * 128 : 0;
}
__host__ __device__ inline size_t bt_red_bytes(int B, int U) {
  return B > 64 ? 0 : (size_t)64 * U * sizeof(float);
}
__host__ __device__ inline int bt_stages(int B, int H, int U, bool dw) {
  const size_t fixed = TC_ALIGN + bt_w_bytes(H, U) + bt_hs_bytes(B, U, dw) + bt_red_bytes(B, U) +
                       BT_BAR_BYTES;
  const int room = fixed < (size_t)TC_SMEM_LIMIT ? (int)((TC_SMEM_LIMIT - fixed) / bt_stage_bytes(B)) : 0;
  const int per_step = 4 * H / BT_SC;
  const int s = room < BT_MAX_STAGES ? room : BT_MAX_STAGES;
  return s < per_step ? s : per_step;
}
__host__ __device__ inline size_t bt_smem_bytes(int B, int H, int U, bool dw) {
  return TC_ALIGN + bt_w_bytes(H, U) + (size_t)bt_stages(B, H, U, dw) * bt_stage_bytes(B) +
         bt_hs_bytes(B, U, dw) + bt_red_bytes(B, U) + BT_BAR_BYTES;
}

template <bool WITH_DW, int U>
__global__ void __launch_bounds__(BT_THREADS, 1)
    lstm_bwd_tc_kernel(BwdTcArgs a, const __grid_constant__ CUtensorMap xmap, unsigned* sync) {
  using T = __nv_bfloat16;
  constexpr int NACC = U / 2;  // a thread's accumulators of a 64 x U tile
  constexpr int NP = U / 8;    // its n8 tiles: unit pairs a row
  extern __shared__ __align__(TC_ALIGN) unsigned char smem_raw[];

  const int H = a.H, B = a.B, seq_len = a.T, G = 4 * H;
  const int bpd = H / U;
  const int nd = gridDim.x / bpd;   // the launch's directions
  const int dl = blockIdx.x / bpd;  // the launch's direction index: its counter, its exchange
  const int d = a.dir0 + dl;
  const int u0 = (blockIdx.x % bpd) * U;
  const bool rev = (a.rev_bits >> d) & 1;  // the forward scan walked time descending
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows_box = bt_box_rows(B);
  const int S = bt_stages(B, H, U, WITH_DW);
  const int per_step = G / BT_SC;
  const int box_bytes = rows_box * 128;
  const int stage_bytes = 2 * box_bytes;

  unsigned char* w_s =
      smem_raw + ((TC_ALIGN - (smem_u32(smem_raw) & (TC_ALIGN - 1))) & (TC_ALIGN - 1));
  unsigned char* ring = w_s + bt_w_bytes(H, U);
  unsigned char* hs_s = ring + (size_t)S * stage_bytes;
  float* red_s = reinterpret_cast<float*>(hs_s + bt_hs_bytes(B, U, WITH_DW));
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(red_s) +
                                               bt_red_bytes(B, U));
  const uint32_t w_addr = smem_u32(w_s), ring_addr = smem_u32(ring), hs_addr = smem_u32(hs_s);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + BT_MAX_STAGES);

  // W_hh rows [u0, u0 + U) of direction d, 16-byte pieces into the swizzled tiles
  const T* w_hh = static_cast<const T*>(a.w_hh) + (long long)d * H * G;
  for (int idx = tid; idx < U * G / 8; idx += BT_THREADS) {
    const int n = idx / (G / 8), k = 8 * (idx % (G / 8));
    *reinterpret_cast<uint4*>(w_s + (k / 64) * U * 128 + swz(n, (k % 64) >> 3)) =
        *reinterpret_cast<const uint4*>(w_hh + (long long)(u0 + n) * G + k);
  }
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, BT_CONSUMERS / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  fence_proxy_async();  // W_hh, written by st.shared, is read by wgmma
  __syncthreads();

  // ---- the producer: lane 0 of the last warp fills the ring
  if (warp == BT_CONSUMERS / 32) {
    if (lane == 0) {
      int slot = 0;
      unsigned phase = 0;
      for (int s = 1; s < seq_len; ++s) {
        const unsigned target = (unsigned)s * bpd;
        while (load_acquire(sync + dl) < target) {
        }
        fence_proxy_async_global();  // the acquire, then the TMA reads of what it published
        for (int c = 0; c < per_step; ++c) {
          mbar_wait(empty0 + 8 * slot, phase ^ 1);
          const uint32_t full = full0 + 8 * slot;
          mbar_arrive_expect_tx(full, stage_bytes);
          const uint32_t dst = ring_addr + slot * stage_bytes;
          // step s - 1's half of the exchange, this direction's slab
          const int slab = ((s - 1) & 1) * nd + dl;
          tma_load_3d(dst, &xmap, full, c * BT_SC, 0, slab);
          tma_load_3d(dst + box_bytes, &xmap, full, c * BT_SC + 64, 0, slab);
          if (++slot == S) slot = 0, phase ^= 1;
        }
      }
    }
    return;
  }
  // a stage is free once every consumer warp is done with it
  auto release = [&](int slot_done) {
    if (lane == 0) mbar_arrive(empty0 + 8 * slot_done);
  };

  // ---- the consumers
  const int wg = warp / 4;
  const bool split = B <= 64;     // both warpgroups on rows 0..63, one box of a stage each
  const int rg = split ? 0 : wg;  // the 64 rows of the warpgroup's dh product
  const bool owner = !split || wg == 0;  // whose threads hold cells
  const int r_base = rg * 64 + (warp % 4) * 16 + (lane >> 2);
  const int ucol = 2 * (lane & 3);
  int len[2];
  bool live[2], m_last[2] = {false, false};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    live[h] = owner && r_base + 8 * h < B;
    len[h] = live[h] ? a.lengths[r_base + 8 * h] : 0;
  }
  // cell q = 4 j + 2 h + e: row r_base + 8 h, unit 8 j + ucol + e (the
  // accumulator layout of wgmma m64nUk16)
  float dh[NACC], dc[NACC], acc[NACC];
  float dw_acc[WITH_DW ? BT_DW_TILES : 1][NACC];  // WITH_DW: this warpgroup's dW^T tiles
#pragma unroll
  for (int q = 0; q < NACC; ++q) dh[q] = 0.0f, dc[q] = 0.0f;
  if constexpr (WITH_DW) {
#pragma unroll
    for (int c = 0; c < BT_DW_TILES; ++c)
#pragma unroll
      for (int q = 0; q < NACC; ++q) dw_acc[c][q] = 0.0f;
  }

  // contiguous (B, T, ndir*H) and (B, T, ndir*4H) tensors, at this block's
  // direction and first unit
  const long long sb_h = (long long)seq_len * a.ndir * H, st_h = (long long)a.ndir * H;
  const long long sb_g = (long long)seq_len * a.ndir * G, st_g = (long long)a.ndir * G;
  const T* gates = static_cast<const T*>(a.gates) + (long long)d * G + u0;
  const T* cs = static_cast<const T*>(a.cs) + (long long)d * H + u0;
  const T* hs = static_cast<const T*>(a.hs) + (long long)d * H + u0;
  const T* dy = static_cast<const T*>(a.dy) + (long long)d * H + u0;
  T* dpre = static_cast<T*>(a.dpre) + (long long)d * G + u0;
  T* xbuf = static_cast<T*>(a.xbuf) + (long long)dl * B * G + u0;
  const long long x_half = (long long)nd * B * G;
  auto ld2 = [](const T* p) { return __ldg(reinterpret_cast<const unsigned*>(p)); };
  auto unpack = [](unsigned w, int e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    return e ? f.y : f.x;
  };

  int slot = 0, prev_slot = 0;
  unsigned phase = 0;
  for (int s = 0; s < seq_len; ++s) {
    const int t = rev ? s : seq_len - 1 - s;
    const bool has_prev = rev ? (t + 1 < seq_len) : (t > 0);
    const int t_prev = rev ? t + 1 : t - 1;  // the forward scan's previous frame

    // 0. this frame's inputs: hs_t's U columns (WITH_DW), the cells' saved values
    uint4 hv = make_uint4(0, 0, 0, 0);
    const int hb = tid / NP, hp = tid % NP;  // hs_t: row hb, units 8 hp .. 8 hp + 7
    if (WITH_DW && s > 0 && hb < B)
      hv = __ldg(reinterpret_cast<const uint4*>(hs + hb * sb_h + (long long)t * st_h + 8 * hp));
    bool valid[2];
    unsigned v_g[NP][2][4], v_c[NP][2], v_cp[NP][2], v_dy[NP][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      valid[h] = live[h] && t < len[h];
      const long long row = r_base + 8 * h;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int unit = 8 * j + ucol;
        v_c[j][h] = v_cp[j][h] = v_dy[j][h] = 0u;
#pragma unroll
        for (int g = 0; g < 4; ++g) v_g[j][h][g] = 0u;
        if (valid[h]) {
          const T* gp = gates + row * sb_g + (long long)t * st_g + unit;
#pragma unroll
          for (int g = 0; g < 4; ++g) v_g[j][h][g] = ld2(gp + g * H);
          v_c[j][h] = ld2(cs + row * sb_h + (long long)t * st_h + unit);
          v_dy[j][h] = ld2(dy + row * sb_h + (long long)t * st_h + unit);
          if (has_prev) v_cp[j][h] = ld2(cs + row * sb_h + (long long)t_prev * st_h + unit);
        }
      }
    }

    if (s > 0) {
      if (WITH_DW) {
        // hs_t as the dW product's B operand: K = the rows, N = the U units,
        // K-major (unit n's rows 64 a 128-byte row); rows past B are zero
        if (hb < rows_box) {
          const T* e = reinterpret_cast<const T*>(&hv);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            *reinterpret_cast<T*>(hs_s + (hb / 64) * U * 128 + swz(8 * hp + i, (hb % 64) >> 3) +
                                  (hb & 7) * 2) = e[i];
        }
        fence_proxy_async();
        named_barrier(1, BT_CONSUMERS);
      }
      // 1-2. dh_prev = dpre_{t_last} @ W_hh[own units]^T over the ring
#pragma unroll
      for (int q = 0; q < NACC; ++q) acc[q] = 0.0f;
      auto chunk = [&](int c, float(&dwt)[NACC]) {  // dwt: WITH_DW only
        mbar_wait(full0 + 8 * slot, phase);
        const uint32_t st = ring_addr + slot * stage_bytes;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (split && j != wg) continue;
          const uint32_t a_t = st + j * box_bytes + rg * 64 * 128;
          const uint32_t b_t = w_addr + (2 * c + j) * U * 128;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16<U>(acc, sw128_desc(a_t + kk * 32), sw128_desc(b_t + kk * 32));
        }
        if constexpr (WITH_DW) {
          // dW^T[box wg's 64 columns, own units] += dpre_box^T . hs_t, K = rows
          const uint32_t a_t = st + wg * box_bytes;
          for (int kk = 0; kk < rows_box / 16; ++kk)
            wgmma_bf16<U, 1>(dwt, sw128_desc(a_t + kk * 2048),
                             sw128_desc(hs_addr + (kk / 4) * U * 128 + (kk % 4) * 32));
        }
        wgmma_commit();
        if (c > 0) {  // the previous chunk's products are done: release its stage
          wgmma_wait<1>(acc);
          release(prev_slot);
        }
        prev_slot = slot;
        if (++slot == S) slot = 0, phase ^= 1;
      };
      if constexpr (WITH_DW) {
#pragma unroll
        for (int c = 0; c < BT_DW_TILES; ++c)
          if (c < per_step) chunk(c, dw_acc[c]);
      } else {
        for (int c = 0; c < per_step; ++c) chunk(c, acc);
      }
      wgmma_wait<0>(acc);
      release(prev_slot);
      if (split) {  // warpgroup 1's half of k into warpgroup 0's sums
        const int r = (warp % 4) * 16 + (lane >> 2);
        if (wg == 1) {
#pragma unroll
          for (int q = 0; q < NACC; ++q)
            red_s[(r + 8 * ((q >> 1) & 1)) * U + 8 * (q >> 2) + ucol + (q & 1)] = acc[q];
        }
        named_barrier(1, BT_CONSUMERS);
        if (wg == 0) {
#pragma unroll
          for (int q = 0; q < NACC; ++q)
            acc[q] += red_s[(r + 8 * ((q >> 1) & 1)) * U + 8 * (q >> 2) + ucol + (q & 1)];
        }
      }
    }

    // 3. this frame's dpre and the dc carry of each cell
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live[h]) continue;
      const long long row = r_base + 8 * h;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        float dp[4][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 4 * j + 2 * h + e;
          if (s > 0 && m_last[h]) dh[q] = acc[q];  // a padded frame leaves dh as it was
#pragma unroll
          for (int g = 0; g < 4; ++g) dp[g][e] = 0.0f;
          if (valid[h]) {
            const float gi = unpack(v_g[j][h][0], e), gf = unpack(v_g[j][h][1], e);
            const float gg = unpack(v_g[j][h][2], e), go = unpack(v_g[j][h][3], e);
            const float c_t = unpack(v_c[j][h], e), c_p = unpack(v_cp[j][h], e);
            const float tanh_ct = tanhf(c_t);
            const float dh_total = unpack(v_dy[j][h], e) + dh[q];
            const float dc_total = dc[q] + dh_total * go * (1.0f - tanh_ct * tanh_ct);
            dp[0][e] = dc_total * gg * gi * (1.0f - gi);
            dp[1][e] = dc_total * c_p * gf * (1.0f - gf);
            dp[2][e] = dc_total * gi * (1.0f - gg * gg);
            dp[3][e] = dh_total * tanh_ct * go * (1.0f - go);
            dc[q] = dc_total * gf;  // dh is replaced by dh_prev at the next step
          }
        }
        T* prow = dpre + row * sb_g + (long long)t * st_g + 8 * j + ucol;
        T* xrow = xbuf + (s & 1) * x_half + row * G + 8 * j + ucol;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          store_bf16<2>(prow + g * H, dp[g]);
          store_bf16<2>(xrow + g * H, dp[g]);
        }
      }
      m_last[h] = valid[h];
    }

    // 4. publish dpre_t to this direction's blocks
    if (s + 1 < seq_len) {
      fence_proxy_async_global();  // this step's dpre, stored by the generic proxy, is read by TMA
      named_barrier(1, BT_CONSUMERS);
      if (tid == 0) arrive_release(sync + dl);
    }
  }

  if constexpr (WITH_DW) {
    // dW_hh rows [u0, u0 + U): warpgroup wg holds columns 128 c + 64 wg + m
    float* dw = a.dw + (long long)d * H * G;
    const int m = (warp % 4) * 16 + (lane >> 2);
#pragma unroll
    for (int c = 0; c < BT_DW_TILES; ++c) {
      fence_operands(dw_acc[c]);
      if (c < per_step) {
#pragma unroll
        for (int q = 0; q < NACC; ++q) {
          const int n = 8 * (q >> 2) + ucol + (q & 1);
          const int k = c * BT_SC + wg * 64 + m + 8 * ((q >> 1) & 1);
          dw[(long long)(u0 + n) * G + k] = dw_acc[c][q];
        }
      }
    }
  }
}
