// The bfloat16 adjoint of the LSTM recurrence on tensor cores, instantiated by
// lstm_bwd_tc.cu (whose header says what it replaces, what bounds it and why
// it is laid out so). What it computes is lstm_bwd.cu's, term for term.
//
// Geometry. One cooperative launch takes up to BT_ROWS = 128 batch rows and
// every direction of the layer, its rows in `groups` balanced row groups
// (G = 1 or 2; the first B % G groups one row more: 48 + 48 at B = 96, 33 +
// 32 at B = 65). Each (direction, row group) is a chain of its own: its
// counter, its rows of the exchange and its tensor map, which holds only
// those rows (TMA fills the box's rows past them with zeros). Batch rows are
// independent in the recurrence, so no chain ever waits for another. A
// block owns U hidden units of one chain (8 or 16: at most 132 blocks in
// all) and keeps their ROWS of W_hh, U x 4H bf16, in shared memory for the
// whole sequence as the tensor cores' B operand (K-major: unit n's 4H
// values, 64 a 128-byte row, the 128-byte swizzle, one U-row tile per 64 k).
// 384 threads: two consumer warpgroups and a producer warpgroup, whose first
// warp's lane 0 alone works; it gives its registers to the consumers
// (setmaxnreg: 232 a consumer thread, which holds at 16 units 128 fp32 of dW
// besides its cells). Each step s (frame t):
//   0. the consumers load this frame's saved gates, c_t, c_prev and dy of
//      their cells into registers (and, WITH_DW, hs_t's U columns of the
//      group's rows into a K-major swizzled tile), independent of the
//      recurrence;
//   1. the producer's lane 0 waits until every block of ITS chain has
//      published dpre_{t_last} (an acquire-polled counter), then streams the
//      group's rows x 4H of the exchange through a ring of stages of 128
//      columns, each two 64-column TMA boxes with the 128-byte swizzle,
//      completing on the stage's `full` mbarrier;
//   2. the consumers wait on `full`, run wgmma.m64nUk16 (bf16 operands from
//      shared memory, fp32 accumulators). SPLIT (a chain of at most 64 rows,
//      the box 64 rows): both warpgroups take the same rows, each one box of
//      every stage, and their sums meet in a shared tile; else (G = 1 past
//      64 rows) each warpgroup takes 64 rows over all k. WITH_DW, warpgroup
//      w then adds box w's dW^T tile: dW^T[cols, own units] += dpre_box^T
//      (M-major A, the same stage) . hs_t (B = the box's rows), into
//      accumulators it keeps in registers for the whole sequence, in the same
//      commit group. A stage's products are waited for one chunk later and
//      the stage released through its `empty` mbarrier (one arrival a
//      consumer warp); no block-wide barrier a chunk;
//   3. the cell epilogue: a thread's cells are accumulators it holds (rows
//      16 (warp % 4) + lane / 4 + 8 h, units 8 j + 2 (lane % 4) (+ 1)): both
//      row halves h, or under SPLIT the half h = its warpgroup, whose other
//      warpgroup's sum it takes from the shared tile; dh and dc carried in
//      registers; the rounded dpre is stored to the output and to the
//      exchange buffer's half of this step;
//   4. one named barrier of the consumers, then one thread arrives on the
//      chain's counter (release).
// WITH_DW and G = 2, each block of group 1 stores its partial dW_hh and
// arrives once more on its chain's counter; the block of group 0 with the
// same units waits for that, then stores its own partial plus group 1's.
// No atomics and no k split across blocks: two calls repeat bit for bit, and
// the form WITH_DW gives the same dpre as the form without (the dW products
// never touch dh's accumulators).
#pragma once

#include <cuda.h>  // CUtensorMap (the entry point is reached through the runtime)

#include "lstm_common.cuh"
#include "wgmma_common.cuh"

constexpr int BT_CONSUMERS = 256;                // two warpgroups
constexpr int BT_THREADS = BT_CONSUMERS + 128;   // and the producer warpgroup
// registers a thread: the launch gives each of the 384 threads 168; the
// producer warpgroup gives up all but 40, the consumers take 232
constexpr int BT_PRODUCER_REGS = 40;
constexpr int BT_CONSUMER_REGS = 232;
constexpr int BT_ROWS = 128;                     // batch rows a launch
constexpr int BT_GROUP_ROWS = 64;                // rows a row group at most (G > 1)
constexpr int BT_MAX_GROUPS = BT_ROWS / BT_GROUP_ROWS;
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
  int dir0;                     // the launch runs directions [dir0, dir0 + its directions)
  int groups;                   // row groups, each its own chain (1 or 2)
};

// the exchange's rows of each row group: map g reads group g's rows only
struct BtMaps {
  CUtensorMap m[BT_MAX_GROUPS];
};

// Row group g of a launch of B rows in G groups: its first row and its rows.
__host__ __device__ inline int bt_group_row0(int B, int G, int g) {
  return g * (B / G) + (g < B % G ? g : B % G);
}
__host__ __device__ inline int bt_group_rows(int B, int G, int g) {
  return B / G + (g < B % G ? 1 : 0);
}

// The block's shared memory, in this order: W_hh rows (U x 4H bf16); the
// ring, whole stages of a chain's most rows rounded up to 64 (64 or 128) x
// 128 columns, at most BT_MAX_STAGES and at most the stages of one step;
// WITH_DW the hs_t tile (rows x U bf16); up to 64 rows the reduction tile
// (64 x U fp32); the mbarriers. Everything from the ring on fills what W_hh
// leaves of TC_SMEM_LIMIT, after the slack that puts the tiles on a
// 1024-byte boundary. `B` here is a chain's rows.
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

template <bool WITH_DW, int U, bool SPLIT>
__global__ void __launch_bounds__(BT_THREADS, 1)
    lstm_bwd_tc_kernel(BwdTcArgs a, const __grid_constant__ BtMaps maps, unsigned* sync) {
  // dW_hh only in chains of at most 64 rows (the plan's: H <= 512 takes two
  // row groups past 64 rows), whose hs_t tile is one 64-row tile
  static_assert(!WITH_DW || SPLIT, "dW_hh is summed in chains of at most 64 rows");
  using T = __nv_bfloat16;
  constexpr int NACC = U / 2;          // a thread's accumulators of a 64 x U tile
  constexpr int NP = U / 8;            // its n8 tiles: unit pairs a row
  constexpr int HN = SPLIT ? 1 : 2;    // the row halves whose cells it holds
  constexpr int NC = 2 * NP * HN;      // its cells: c = 2 (HN j + hh) + e
  constexpr int ROWS_BOX = SPLIT ? 64 : 128;
  extern __shared__ __align__(TC_ALIGN) unsigned char smem_raw[];

  const int H = a.H, B = a.B, seq_len = a.T, G = 4 * H, ng = a.groups;
  const int bpd = H / U;                  // blocks of a chain
  const int chain = blockIdx.x / bpd;     // its counter: direction x row groups + group
  const int nd = gridDim.x / (bpd * ng);  // the launch's directions
  const int dl = chain / ng, grp = chain % ng;
  const int d = a.dir0 + dl;
  const int u0 = (blockIdx.x % bpd) * U;
  const int row0 = bt_group_row0(B, ng, grp), rows = bt_group_rows(B, ng, grp);
  const bool rev = (a.rev_bits >> d) & 1;  // the forward scan walked time descending
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = bt_stages(bt_group_rows(B, ng, 0), H, U, WITH_DW);
  const int per_step = G / BT_SC;
  constexpr int box_bytes = ROWS_BOX * 128;
  constexpr int stage_bytes = 2 * box_bytes;

  unsigned char* w_s =
      smem_raw + ((TC_ALIGN - (smem_u32(smem_raw) & (TC_ALIGN - 1))) & (TC_ALIGN - 1));
  unsigned char* ring = w_s + bt_w_bytes(H, U);
  unsigned char* hs_s = ring + (size_t)S * stage_bytes;
  float* red_s = reinterpret_cast<float*>(hs_s + bt_hs_bytes(ROWS_BOX, U, WITH_DW));
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(red_s) +
                                               bt_red_bytes(ROWS_BOX, U));
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

  // ---- the producer: lane 0 of the producer warpgroup's first warp fills the ring
  if (warp >= BT_CONSUMERS / 32) {
    regs_dealloc<BT_PRODUCER_REGS>();
    if (warp == BT_CONSUMERS / 32 && lane == 0) {
      const CUtensorMap* xmap = &maps.m[grp];
      int slot = 0;
      unsigned phase = 0;
      for (int s = 1; s < seq_len; ++s) {
        const unsigned target = (unsigned)s * bpd;
        while (load_acquire(sync + chain) < target) {
        }
        fence_proxy_async_global();  // the acquire, then the TMA reads of what it published
        for (int c = 0; c < per_step; ++c) {
          mbar_wait(empty0 + 8 * slot, phase ^ 1);
          const uint32_t full = full0 + 8 * slot;
          mbar_arrive_expect_tx(full, stage_bytes);
          const uint32_t dst = ring_addr + slot * stage_bytes;
          // step s - 1's half of the exchange, this direction's slab
          const int slab = ((s - 1) & 1) * nd + dl;
          tma_load_3d(dst, xmap, full, c * BT_SC, 0, slab);
          tma_load_3d(dst + box_bytes, xmap, full, c * BT_SC + 64, 0, slab);
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
  regs_alloc<BT_CONSUMER_REGS>();
  const int wg = warp / 4;
  const int rg = SPLIT ? 0 : wg;  // the 64 rows of the warpgroup's dh product
  const int r_base = rg * 64 + (warp % 4) * 16 + (lane >> 2);  // the chain's row of half 0
  const int ucol = 2 * (lane & 3);
  // the row half (8 rows apart) of the thread's half hh
  auto half = [&](int hh) { return SPLIT ? wg : hh; };
  int len[HN];
  bool live[HN], m_last[HN];
#pragma unroll
  for (int hh = 0; hh < HN; ++hh) {
    const int r = r_base + 8 * half(hh);
    live[hh] = r < rows;
    len[hh] = live[hh] ? a.lengths[row0 + r] : 0;
    m_last[hh] = false;
  }
  // accumulator q = 4 j + 2 h + e: row r_base + 8 h, unit 8 j + ucol + e (the
  // layout of wgmma m64nUk16); the thread's cell c = 2 (HN j + hh) + e
  float dh[NC], dc[NC], acc[NACC];
  float dw_acc[WITH_DW ? BT_DW_TILES : 1][NACC];  // WITH_DW: this warpgroup's dW^T tiles
#pragma unroll
  for (int c = 0; c < NC; ++c) dh[c] = 0.0f, dc[c] = 0.0f;
  if constexpr (WITH_DW) {
#pragma unroll
    for (int c = 0; c < BT_DW_TILES; ++c)
#pragma unroll
      for (int q = 0; q < NACC; ++q) dw_acc[c][q] = 0.0f;
  }

  // contiguous (B, T, ndir*H) and (B, T, ndir*4H) tensors, at this block's
  // direction, first row and first unit
  const long long sb_h = (long long)seq_len * a.ndir * H, st_h = (long long)a.ndir * H;
  const long long sb_g = (long long)seq_len * a.ndir * G, st_g = (long long)a.ndir * G;
  const T* gates = static_cast<const T*>(a.gates) + row0 * sb_g + (long long)d * G + u0;
  const T* cs = static_cast<const T*>(a.cs) + row0 * sb_h + (long long)d * H + u0;
  const T* hs = static_cast<const T*>(a.hs) + row0 * sb_h + (long long)d * H + u0;
  const T* dy = static_cast<const T*>(a.dy) + row0 * sb_h + (long long)d * H + u0;
  T* dpre = static_cast<T*>(a.dpre) + row0 * sb_g + (long long)d * G + u0;
  T* xbuf = static_cast<T*>(a.xbuf) + ((long long)dl * B + row0) * G + u0;
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
    if (WITH_DW && s > 0 && hb < rows)
      hv = __ldg(reinterpret_cast<const uint4*>(hs + hb * sb_h + (long long)t * st_h + 8 * hp));
    bool valid[HN];
    unsigned v_g[NP][HN][4], v_c[NP][HN], v_cp[NP][HN], v_dy[NP][HN];
#pragma unroll
    for (int hh = 0; hh < HN; ++hh) {
      valid[hh] = live[hh] && t < len[hh];
      const long long row = r_base + 8 * half(hh);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int unit = 8 * j + ucol;
        v_c[j][hh] = v_cp[j][hh] = v_dy[j][hh] = 0u;
#pragma unroll
        for (int g = 0; g < 4; ++g) v_g[j][hh][g] = 0u;
        if (valid[hh]) {
          const T* gp = gates + row * sb_g + (long long)t * st_g + unit;
#pragma unroll
          for (int g = 0; g < 4; ++g) v_g[j][hh][g] = ld2(gp + g * H);
          v_c[j][hh] = ld2(cs + row * sb_h + (long long)t * st_h + unit);
          v_dy[j][hh] = ld2(dy + row * sb_h + (long long)t * st_h + unit);
          if (has_prev) v_cp[j][hh] = ld2(cs + row * sb_h + (long long)t_prev * st_h + unit);
        }
      }
    }

    // dh_prev of the thread's cells (this step's product)
    float sum[NC];
    if (s > 0) {
      if (WITH_DW) {
        // hs_t as the dW product's B operand: K = the rows, N = the U units,
        // K-major (unit n's rows 64 a 128-byte row); rows past the chain's are zero
        if (hb < ROWS_BOX) {
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
          if (SPLIT && j != wg) continue;
          const uint32_t a_t = st + j * box_bytes + rg * 64 * 128;
          const uint32_t b_t = w_addr + (2 * c + j) * U * 128;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16<U>(acc, sw128_desc(a_t + kk * 32), sw128_desc(b_t + kk * 32));
        }
        if constexpr (WITH_DW) {
          // dW^T[box wg's 64 columns, own units] += dpre_box^T . hs_t, K = rows
          const uint32_t a_t = st + wg * box_bytes;
#pragma unroll
          for (int kk = 0; kk < ROWS_BOX / 16; ++kk)
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
      if constexpr (SPLIT) {
        // each warpgroup holds half of k for every cell: the other half's
        // cells go through the shared tile to the warpgroup that holds them
        const int r = (warp % 4) * 16 + (lane >> 2);
#pragma unroll
        for (int j = 0; j < NP; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            red_s[(r + 8 * (1 - wg)) * U + 8 * j + ucol + e] =
                wg ? acc[4 * j + e] : acc[4 * j + 2 + e];
        named_barrier(1, BT_CONSUMERS);
#pragma unroll
        for (int j = 0; j < NP; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sum[2 * j + e] = (wg ? acc[4 * j + 2 + e] : acc[4 * j + e]) +
                             red_s[(r + 8 * wg) * U + 8 * j + ucol + e];
      } else {
#pragma unroll
        for (int j = 0; j < NP; ++j)
#pragma unroll
          for (int hh = 0; hh < HN; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) sum[2 * (HN * j + hh) + e] = acc[4 * j + 2 * hh + e];
      }
    }

    // 3. this frame's dpre and the dc carry of each cell
#pragma unroll
    for (int hh = 0; hh < HN; ++hh) {
      if (!live[hh]) continue;
      const long long row = r_base + 8 * half(hh);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        float dp[4][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * (HN * j + hh) + e;
          if (s > 0 && m_last[hh]) dh[c] = sum[c];  // a padded frame leaves dh as it was
#pragma unroll
          for (int g = 0; g < 4; ++g) dp[g][e] = 0.0f;
          if (valid[hh]) {
            const float gi = unpack(v_g[j][hh][0], e), gf = unpack(v_g[j][hh][1], e);
            const float gg = unpack(v_g[j][hh][2], e), go = unpack(v_g[j][hh][3], e);
            const float c_t = unpack(v_c[j][hh], e), c_p = unpack(v_cp[j][hh], e);
            const float tanh_ct = tanhf(c_t);
            const float dh_total = unpack(v_dy[j][hh], e) + dh[c];
            const float dc_total = dc[c] + dh_total * go * (1.0f - tanh_ct * tanh_ct);
            dp[0][e] = dc_total * gg * gi * (1.0f - gi);
            dp[1][e] = dc_total * c_p * gf * (1.0f - gf);
            dp[2][e] = dc_total * gi * (1.0f - gg * gg);
            dp[3][e] = dh_total * tanh_ct * go * (1.0f - go);
            dc[c] = dc_total * gf;  // dh is replaced by dh_prev at the next step
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
      m_last[hh] = valid[hh];
    }

    // 4. publish dpre_t to this chain's blocks
    if (s + 1 < seq_len) {
      fence_proxy_async_global();  // this step's dpre, stored by the generic proxy, is read by TMA
      named_barrier(1, BT_CONSUMERS);
      if (tid == 0) arrive_release(sync + chain);
    }
  }

  if constexpr (WITH_DW) {
    // dW_hh rows [u0, u0 + U): warpgroup wg holds columns 128 c + 64 wg + m.
    // Of two row groups, group 0 adds group 1's partial, stored by the block
    // of group 1 with the same units and published by its last arrival.
    float* dw = a.dw + (long long)d * H * G;
    const int m = (warp % 4) * 16 + (lane >> 2);
    const bool adds = ng > 1 && grp == 0;
    if (adds) {
      while (load_acquire(sync + chain + 1) < (unsigned)seq_len * bpd) {
      }
    }
#pragma unroll
    for (int c = 0; c < BT_DW_TILES; ++c) {
      fence_operands(dw_acc[c]);
      if (c < per_step) {
#pragma unroll
        for (int q = 0; q < NACC; ++q) {
          const int n = 8 * (q >> 2) + ucol + (q & 1);
          const int k = c * BT_SC + wg * 64 + m + 8 * ((q >> 1) & 1);
          float* p = dw + (long long)(u0 + n) * G + k;
          *p = adds ? dw_acc[c][q] + __ldcg(p) : dw_acc[c][q];
        }
      }
    }
    if (ng > 1 && grp > 0) {
      named_barrier(1, BT_CONSUMERS);
      if (tid == 0) arrive_release(sync + chain);
    }
  }
}
