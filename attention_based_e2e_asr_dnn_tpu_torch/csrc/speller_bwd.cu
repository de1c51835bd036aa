// Adjoint of the fused speller decode (speller_decode.cu, TRAIN = true) for
// Hopper (sm_90a), in float32 on the CUDA cores: one cooperative launch walks
// every step of the decode backwards for the whole batch. bfloat16 runs on
// speller_bwd_tc.cu (the three products on tensor cores).
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/speller_pallas.py):
//   _decode_bwd_kernel (:223), launched by _bwd_chunk (:554, the call at
//   :578): TPU kernel #9.
//
// What it computes. Time runs down from T - 1 to 0. With the forward's saved
// streams (both cells' activated gates and c, the attention weights w, the
// dropout masks m1, m2), the upstream cotangents of q and of the context
// through the tied classifier (dqup, dctxup) and, where the caller has one,
// of the weights (dwup), and the fp32 carries dh1, dc1, dh2, dc2, dctx (zero
// at t = T - 1), a step is four phases, each needing the previous one:
//   (a) per batch row and head: d_ctx = dctx + dctxup[t];
//       dw = d_ctx . V (+ dwup[t]);  dsc = w * (dw - sum(dw * w));
//       dq_att = (dsc * scale) . K;  d_q = dq_att + dqup[t];
//   (b) d_h2d = dh2 + d_q @ wq^T; times m2[t]; cell 2's gate adjoint
//       with c2[t] and c2[t - 1] (c20 at t = 0) -> dpre2; dc2 = dc2_tot * f2;
//   (c) d_h1d = dh1 + dpre2 @ wih2^T and dh2 = dpre2 @ whh2^T;
//       d_h1d times m1[t]; cell 1's gate adjoint -> dpre1; dc1 = dc1_tot * f1;
//   (d) dh1 = dpre1 @ whh1^T and dctx = dpre1 @ wc1^T.
// Streams out, in float32: dpre1 (T, B, 4H1), dpre2 (T, B, 4H2), dq and
// dctxtot (= d_ctx) (T, B, P), dsc (T, B, heads, Te). After t = 0 the carries
// are the outputs dh10, dc10, dh20, dc20, dctx0. Every value is fp32 and every
// product plain FMA (no TF32: float32 keeps its 1e-4 tolerance); the
// attention's products are unfused from their sums, as in the Pallas kernel's
// interpret mode (ops/speller_cuda.py's plain version).
//
// What bounds it on this card. A step's three products are B x (P H2 + 4 H2
// (H1 + H2) + 4 H1 (H1 + P)) FMAs (2.4M a row at base-LAS: ~9.4 us a step at
// B = 128 on the 67 TFLOP/s float32 peak), every phase needs the whole
// previous one of the same rows, and each block that owns columns of a
// product reads its rows' whole input from L2: dq[t], dpre2[t] and dpre1[t]
// (13.3 KB a row at base-LAS, 21.5 KB at scaled-LAS). The first body gave
// each of 128 blocks a few columns and walked every batch row in every
// phase, two rows a warp, butterflies summing the lanes, four grid barriers a
// step: ~218 MB read from L2 a step at base-LAS, B = 128 (~100 us a step).
// This body's step on an H100 (tools/trace_speller_decode.py --adjoint
// --float32; PERF.md has the times) is the longest attention item of a row
// group, which every block of the group waits for (~15 us at base-LAS: a
// 192-frame row's K and V, 393 KB, through a chain of dependent loads), then
// the three products, each bound by the stages it can keep in flight (~25-30
// GB/s into a block at ~1 us a stage) and by its threads' FMA issue, and
// ~1.5 us a hand-off between phases.
//
// Design (ops/speller_cuda.py::plan_decode_bwd_f32 picks the geometry).
//   * Ownership by unit. G = CG x RG blocks; block (rg, cg) takes the RG-th
//     group of R batch rows and owns U1 = H1 / CG units of cell 1, U2 = H2 /
//     CG of cell 2 and NQ = P / CG context columns, any number of each: (b)
//     forms its cell-2 units' columns (gate adjoint), (c) its cell-1 units'
//     (gate adjoint) and its cell-2 units' new dh2, (d) its cell-1 units' new
//     dh1 and its context columns of the new dctx. So the dh / dc carries of
//     a unit never leave its block (they live in the output buffers, touched
//     by that block only), and the block keeps those units' weight rows
//     resident, [k][column], for the whole launch: (d)'s too where they fit,
//     else (`stream`) they come through the ring beside (d)'s input each
//     step, their boxes loaded before the wait for that input (they do not
//     depend on it).
//   * Products as register tiles. A phase's input (dq[t], dpre2[t],
//     dpre1[t]: the output streams double as the exchanges) streams through a
//     ring of stages, each up to DA_MAX_BOXES TMA boxes of S rows x 128 k
//     (unswizzled rows of 132 floats: the 4 past 128 k, read from the next
//     chunk and unused, pad the rows so that a warp's rows fall in other
//     banks) on full / empty mbarriers, filled by
//     a producer warp. Consumer thread (ks, tile) keeps a tile of 8 rows x
//     WD columns (WD 4, 2 or 1: the widest that divides the phase's columns)
//     in registers and sums it over the k of every stage that falls to its k
//     slice ks (16-byte pieces ks, ks + KS, ...); the KS partial tiles (KS
//     fills the block's threads where the tiles are few: 24 columns x 32 rows
//     make 24 tiles of 8 x 4) meet in shared memory and are
//     summed in the fixed order ks = 0, 1, ... by the thread that applies the
//     epilogue to the (row, column). No warp walks rows; no butterfly sums.
//   * No clusters. Thread-block clusters of C blocks of a row group, each
//     stage's rows split C ways and multicast by TMA to every block of the
//     cluster, would divide the exchange's L2 reads by C; on an H100 that
//     form (C = 2: the card holds 66 clusters of 2 such blocks at once) ran a
//     step 10-18% slower, its blocks waiting for each other at every stage
//     while the L2 reads it saved were not what bound the step (PERF.md).
//   * The attention adjoint over (row, head) items: ordered once by extent,
//     longest first, and dealt to the blocks in a snake (block b takes
//     positions b and 2G - 1 - b of every 2G), as speller_decode.cu deals
//     its rows. An item's extent is one past the last frame whose weight is
//     non-zero at any step (read once at the start): past it dsc is 0, dw is
//     not needed and dq_att gains nothing, so K and V are read only up to it
//     (the forward writes weights of exactly 0 past a row's last unmasked
//     frame). Shared memory holds d_ctx of the head, dw of the item's Te
//     frames and the dq_att group sums; the weights are read from global
//     memory.
//   * Counters in place of grid barriers, per row group: ATTEND (items of
//     the group published), CELL2 and CELL1 (blocks of the group past (b) and
//     (c)), BACK (past (d)); each a monotonic count that a release adds to
//     and one thread acquires. A block waits only for its own rows: the
//     producer for the row group's ATTEND, CELL2 and CELL1 before it loads
//     (b)'s, (c)'s and (d)'s input; the consumers for BACK of an item's row
//     group before its attention. Write-after-read: dctx (the only buffer
//     rewritten) is read by attend (s) and rewritten by (d) (s), which runs
//     after CELL1 (s) of its group, so after every item of the group at step
//     s. Writes that other blocks read by TMA are fenced to the async proxy
//     before the release.
//   * Repeatable: a fixed order of every sum and no atomics on values, so two
//     calls are bit-equal.

#include <stdint.h>

#include "speller_common.cuh"
#include "wgmma_common.cuh"  // smem_u32, mbarriers, TMA, counters, encode_tiled

constexpr int DA_CONSUMERS = 256;                 // the products' and the attention's threads
constexpr int DA_THREADS = DA_CONSUMERS + 32;     // and the producer warp
constexpr int DA_WARPS = DA_CONSUMERS / 32;
constexpr int DA_MAX_GRID = 128;                  // blocks of a launch, at most
constexpr int DA_BOX_K = 128;                     // k of a TMA box
constexpr int DA_LDX = DA_BOX_K + 4;              // floats a box row reads and a staged row holds
constexpr int DA_ROW_BYTES = DA_LDX * 4;
constexpr int DA_MAX_BOXES = 2;                   // boxes of a ring stage, at most
constexpr int DA_MAX_STAGES = 8;                  // ring stages, at most
constexpr int DA_MAX_KS = 16;                     // k slices of a product, at most
constexpr int DA_MAX_BOX_ROWS = 256;              // rows of a TMA box, at most
constexpr int DA_ALIGN = 128;                     // the ring's alignment (TMA boxes)
enum Ctr { C_START, C_RANKED, N_FIXED_CTRS };     // then ATTEND, CELL2, CELL1, BACK a row group
enum GroupCtr { C_ATTEND, C_CELL2, C_CELL1, C_BACK, N_GROUP_CTRS };

// Phase stamps for tools/trace_speller_decode.py (--adjoint --float32).
// Built with -DDA_TRACE, consumer thread 0 of blocks 0, G / 2 and G - 1 writes
// %globaltimer at each phase boundary of the first DA_TRACE_STEPS steps;
// without it DA_STAMP is nothing and the kernel is the same.
enum Stamp {
  S_STEP, S_BACK_ACQUIRED, S_ATTEND_PUBLISHED, S_B_INPUT, S_B_PUBLISHED, S_C_INPUT,
  S_C_PUBLISHED, S_D_INPUT, S_D_PUBLISHED, N_STAMPS
};
#ifdef DA_TRACE
constexpr int DA_TRACE_STEPS = 1024;
__device__ unsigned long long da_trace[3][N_STAMPS][DA_TRACE_STEPS];
__device__ __forceinline__ void da_stamp(int e, int s) {
  const int b = blockIdx.x == 0 ? 0 : blockIdx.x == gridDim.x / 2 ? 1
                                    : blockIdx.x == gridDim.x - 1 ? 2 : -1;
  if (b < 0 || s >= DA_TRACE_STEPS || threadIdx.x != 0) return;
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  da_trace[b][e][s] = v;
}
// the stamps, (3, N_STAMPS, DA_TRACE_STEPS) uint64 nanoseconds (0: not
// written), into `out`; then zeroed
extern "C" int speller_bwd_trace(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, da_trace, sizeof(da_trace));
  void* p = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, da_trace);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(da_trace));
  return (int)err;
}
#define DA_STAMP(e, s) da_stamp(e, s)
#else
#define DA_STAMP(e, s)
#endif

// pointer slots of the launch (the order of ops/speller_cuda.py's list)
enum Ptr {
  P_K, P_V, P_WC1, P_WHH1, P_WIH2, P_WHH2, P_WQ, P_C10, P_C20, P_GATES1, P_C1, P_GATES2, P_C2,
  P_WGTS, P_M1, P_M2, P_DQUP, P_DCTXUP, P_DWUP,
  // outputs
  P_DPRE1, P_DPRE2, P_DQ, P_DCTXTOT, P_DSC, P_DH1, P_DC1, P_DH2, P_DC2, P_DCTX,
  // scratch: each item's extent and the items in order of extent, B x heads
  // int32 each
  P_EXT, P_PERM, N_PTRS
};
// int slots
enum Dim { D_B, D_TE, D_T, D_P, D_HEADS, D_H1, D_H2, N_DIMS };
// the plan's geometry: column groups, row groups, rows a row group, rows a
// product sub-tile, TMA boxes a stage, ring stages, k slices at most, the
// attention's dq_att groups at most, whether (d)'s weight rows stream
// through the ring
enum GeomSlot { G_CG, G_RG, G_ROWS, G_SUB, G_BOXES, G_STAGES, G_KS, G_ATT, G_STREAM, N_GEOM };
// the tensor maps of the three product inputs, then of (d)'s weights
enum Map { M_DQ, M_DPRE2, M_DPRE1, M_WHH1, M_WC1, N_MAPS };

struct BwdArgs {
  const void* p[N_PTRS];
  int B, Te, T, P, heads, H1, H2;
  float scale;
  int cg, rg, rows, sub, boxes, stages, ks, att, stream;
};

struct BwdMaps {
  CUtensorMap m[N_MAPS];
};

// A product's thread tiles over `sub` rows x N columns: DA_RT = 8 rows x WD
// columns, the widest of 4, 2, 1 that divides N (8 x 4 tiles read 12 16-byte
// pieces for 128 FMAs a 4 k), Q = N / WD column tiles, `tiles` in all; KS k
// slices (at most ks_max and the stage's 16-byte pieces) fill the threads:
// the products ran faster with more threads at every shape tried on an
// H100. (Narrower or 4-row tiles where they keep more threads busy sped up
// scaled-LAS's (d) by 2-3 us a step and slowed base-LAS's step as much.)
constexpr int DA_RT = 8;
struct Tiling {
  int wd, q, tiles, ks;
};
__host__ __device__ inline Tiling da_tiling(int sub, int N, int ks_max, int quads) {
  Tiling t;
  t.wd = N % 4 == 0 ? 4 : N % 2 == 0 ? 2 : 1;
  t.q = N / t.wd;
  t.tiles = t.q * (sub / DA_RT);
  int ks = t.tiles > 0 ? DA_CONSUMERS / t.tiles : 0;
  ks = ks < ks_max ? ks : ks_max;
  t.ks = ks < quads ? ks : quads;
  return t;
}

// Shared memory of a block (ops/speller_cuda.py::decode_bwd_f32_smem_bytes
// mirrors it), after DA_ALIGN bytes of slack that put the ring on a 128-byte
// boundary: the ring, stages x boxes x (sub rows of the input, and where
// (d)'s weights stream the block's WR = 8 ceil(U1 / 8) + 8 ceil(NQ / 8)
// weight rows) x DA_ROW_BYTES; a full and an empty mbarrier a stage (16 bytes
// each pair, rounded up to 16); the resident weights, [k][column] fp32: (b) P
// x U2 of wq, (c) 4 H2 x (U1 + U2) of [wih2; whh2], (d) 4 H1 x (U1 + NQ) of
// [whh1; wc1] unless they stream; then one region that the attention (d_ctx
// of a head, dw of Te frames, its dq_att group sums, 8 warp sums) and the
// products' partial tiles (KS x sub x N of the widest phase) take in turn.
__host__ __device__ inline int da_pad8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ inline int da_wrows(int P, int H1, int cg) {
  return da_pad8(H1 / cg) + da_pad8(P / cg);
}
__host__ __device__ inline int da_att_groups(int P, int heads, int att) {
  const int slices = P / heads / 4, most = DA_CONSUMERS / slices;
  return att < most ? att : most;
}
__host__ __device__ inline size_t da_att_floats(int Te, int P, int heads, int att) {
  const int d = P / heads;
  return (size_t)d + Te + (size_t)da_att_groups(P, heads, att) * d + DA_WARPS;
}
__host__ __device__ inline size_t da_red_floats(int sub, int N, int K, int ks_max, int boxes) {
  const int quads = (K < boxes * DA_BOX_K ? K : boxes * DA_BOX_K) / 4;
  const Tiling t = da_tiling(sub, N, ks_max, quads);
  return (size_t)t.ks * sub * N;
}
__host__ __device__ inline size_t da_weight_floats(int P, int H1, int H2, int cg, int stream) {
  const size_t U1 = H1 / cg, U2 = H2 / cg, NQ = P / cg;
  return U2 * P + (U1 + U2) * 4 * H2 + (stream ? 0 : (U1 + NQ) * 4 * H1);
}
__host__ __device__ inline size_t da_region_floats(int Te, int P, int heads, int H1, int H2,
                                                   int cg, int sub, int ks_max, int boxes,
                                                   int att) {
  const int U1 = H1 / cg, U2 = H2 / cg, NQ = P / cg;
  size_t r = da_att_floats(Te, P, heads, att);
  const size_t red[3] = {da_red_floats(sub, U2, P, ks_max, boxes),
                         da_red_floats(sub, U1 + U2, 4 * H2, ks_max, boxes),
                         da_red_floats(sub, U1 + NQ, 4 * H1, ks_max, boxes)};
  for (int i = 0; i < 3; ++i) r = red[i] > r ? red[i] : r;
  return r;
}
__host__ __device__ inline size_t da_smem_bytes(int Te, int P, int heads, int H1, int H2,
                                                int cg, int sub, int boxes, int stages,
                                                int ks_max, int att, int stream) {
  const size_t ring =
      (size_t)stages * boxes * (sub + (stream ? da_wrows(P, H1, cg) : 0)) * DA_ROW_BYTES;
  const size_t bars = align16((size_t)stages * 16);
  return DA_ALIGN + ring + bars +
         (da_weight_floats(P, H1, H2, cg, stream) +
          da_region_floats(Te, P, heads, H1, H2, cg, sub, ks_max, boxes, att)) *
             sizeof(float);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// The gate adjoint of one (row, unit) at step t: d_hd is the cotangent of the
// dropped output (the carry dh plus the product's column); writes the four
// dpre and the new dc.
__device__ __forceinline__ void gate_adjoint(const float* gates_t, const float* c_t,
                                             const float* c_prev_t, const float* mask_t,
                                             float* dpre_t, float* dc_c, bool first, int row, int H,
                                             int unit, float d_hd) {
  const float* grow = gates_t + (long long)row * 4 * H + unit;
  const long long off = (long long)row * H + unit;
  const float gi = ld_nc(grow), gf = ld_nc(grow + H), gg = ld_nc(grow + 2 * H),
              go = ld_nc(grow + 3 * H);
  const float c = ld_nc(c_t + off), c_prev = ld_nc(c_prev_t + off);
  const float d_hn = mask_t != nullptr ? d_hd * ld_nc(mask_t + off) : d_hd;
  const float dc = first ? 0.0f : dc_c[off];
  const float tanh_c = tanhf(c);
  const float dc_tot = dc + d_hn * go * (1.0f - tanh_c * tanh_c);
  float* prow = dpre_t + (long long)row * 4 * H + unit;
  prow[0] = dc_tot * gg * gi * (1.0f - gi);
  prow[H] = dc_tot * c_prev * gf * (1.0f - gf);
  prow[2 * H] = dc_tot * gi * (1.0f - gg * gg);
  prow[3 * H] = d_hn * tanh_c * go * (1.0f - go);
  dc_c[off] = dc_tot * gf;
}
__device__ __forceinline__ void prefetch_gate(const float* gates_t, const float* c_t,
                                              const float* c_prev_t, const float* mask_t, int row,
                                              int H, int unit) {
  const float* grow = gates_t + (long long)row * 4 * H + unit;
  const long long off = (long long)row * H + unit;
  for (int g = 0; g < 4; ++g) prefetch_l2(grow + g * H);
  prefetch_l2(c_t + off);
  prefetch_l2(c_prev_t + off);
  if (mask_t != nullptr) prefetch_l2(mask_t + off);
}

// What the consumers share across the phases of a launch.
struct Ring {
  const unsigned char* base;  // the ring (128-byte aligned)
  uint32_t full0, empty0;     // the stages' mbarriers
  int stage_bytes, stages, boxes, sub;
  int slot;
  unsigned phase;
};

// One sub-tile's product on the ring: acc (DA_RT x WD, thread tile (j, g) of the
// tiling, k slice ks) summed over the K columns of the stages that carry
// them, the partial tile stored to red[ks][row][column] (sub x N a slice).
// The weights: w_s [K][N] resident, or (STREAM) each stage's boxes of the
// block's weight rows after its input boxes, WR rows a box: column c < u1 at
// row c, the others at row 8 ceil(u1 / 8) + c - u1. Every consumer thread
// calls it (those past the tiles x KS threads only walk the ring).
template <int WD, bool STREAM>
__device__ __forceinline__ void product(Ring& rn, const float* w_s, int N, int K, const Tiling& tl,
                                        float* red, int stamp, int step, int u1, int wr) {
  constexpr int RT = DA_RT;
  const int tid = threadIdx.x, lane = tid & 31;
  const int ks = tid / tl.tiles, tile = tid % tl.tiles;
  const bool active = ks < tl.ks;
  const int j = tile % tl.q, g = tile / tl.q;
  const int S = rn.sub, RS = S / RT;
  // the tile's columns: adjacent (WD of them from j WD: one 16-byte load of
  // the resident [k][N] weights), or with STREAM strided (j, j + Q, ...: the
  // warp's lanes read adjacent staged weight rows, without bank conflicts)
  int col[WD], wrow[WD];
#pragma unroll
  for (int c = 0; c < WD; ++c) {
    col[c] = STREAM ? j + c * tl.q : j * WD + c;
    wrow[c] = col[c] < u1 ? col[c] : da_pad8(u1) + col[c] - u1;
  }
  float acc[RT][WD];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < WD; ++c) acc[i][c] = 0.0f;
  const int n_boxes = (K + DA_BOX_K - 1) / DA_BOX_K;
  const int n_stages = (n_boxes + rn.boxes - 1) / rn.boxes;
  for (int st = 0; st < n_stages; ++st) {
    mbar_wait(rn.full0 + 8 * rn.slot, rn.phase);
    if (st == 0 && stamp >= 0) DA_STAMP(stamp, step);
    if (active) {
      const int k0 = st * rn.boxes * DA_BOX_K;
      const int quads = min(rn.boxes * DA_BOX_K, K - k0) / 4;
      const float* base =
          reinterpret_cast<const float*>(rn.base + (size_t)rn.slot * rn.stage_bytes);
      for (int qd = ks; qd < quads; qd += tl.ks) {
        const int box = qd / (DA_BOX_K / 4), c = qd % (DA_BOX_K / 4);
        const float* bx = base + box * S * DA_LDX + 4 * c;
        float4 xv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          xv[i] = *reinterpret_cast<const float4*>(bx + (g + i * RS) * DA_LDX);
        if constexpr (STREAM) {
          const float* wb = base + (rn.boxes * S + box * wr) * DA_LDX + 4 * c;
          float4 wv[WD];
#pragma unroll
          for (int c2 = 0; c2 < WD; ++c2)
            wv[c2] = *reinterpret_cast<const float4*>(wb + wrow[c2] * DA_LDX);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              const float xk = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
              for (int c2 = 0; c2 < WD; ++c2) {
                const float wk = kk == 0 ? wv[c2].x : kk == 1 ? wv[c2].y : kk == 2 ? wv[c2].z
                                                                                   : wv[c2].w;
                acc[i][c2] = fmaf(xk, wk, acc[i][c2]);
              }
            }
          continue;
        }
        const float* wk = w_s + (long long)(k0 + 4 * qd) * N + j * WD;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float w[WD];
          if constexpr (WD == 4) {
            const float4 v = *reinterpret_cast<const float4*>(wk + kk * N);
            w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
          } else if constexpr (WD == 2) {
            const float2 v = *reinterpret_cast<const float2*>(wk + kk * N);
            w[0] = v.x, w[1] = v.y;
          } else {
            w[0] = wk[kk * N];
          }
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float xk = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
            for (int c2 = 0; c2 < WD; ++c2) acc[i][c2] = fmaf(xk, w[c2], acc[i][c2]);
          }
        }
      }
    }
    // the stage is read: each warp releases it
    __syncwarp();
    if (lane == 0) mbar_arrive(rn.empty0 + 8 * rn.slot);
    if (++rn.slot == rn.stages) rn.slot = 0, rn.phase ^= 1;
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < WD; ++c) red[((long long)ks * S + g + i * RS) * N + col[c]] = acc[i][c];
  }
  named_barrier(1, DA_CONSUMERS);
}

template <bool STREAM>
__device__ __forceinline__ void product_wd(Ring& rn, const float* w_s, int N, int K,
                                           const Tiling& tl, float* red, int stamp, int step,
                                           int u1, int wr) {
  switch (tl.wd) {
    case 4: product<4, STREAM>(rn, w_s, N, K, tl, red, stamp, step, u1, wr); break;
    case 2: product<2, STREAM>(rn, w_s, N, K, tl, red, stamp, step, u1, wr); break;
    default: product<1, STREAM>(rn, w_s, N, K, tl, red, stamp, step, u1, wr); break;
  }
}
// one sub-tile's product of N columns over K (stamp: a Stamp to write when
// the first stage has landed, or -1); w_s null: the weights stream (u1, wr:
// product's STREAM rows)
__device__ __forceinline__ void run_product(Ring& rn, const float* w_s, int N, int K, int ks_max,
                                            float* red, int stamp, int step, int u1 = 0,
                                            int wr = 0) {
  const Tiling tl = da_tiling(rn.sub, N, ks_max, min(rn.boxes * DA_BOX_K, K) / 4);
  if (w_s == nullptr)
    product_wd<true>(rn, w_s, N, K, tl, red, stamp, step, u1, wr);
  else
    product_wd<false>(rn, w_s, N, K, tl, red, stamp, step, 0, 0);
}
// the k slices of a product of N columns over K (its tiling's KS)
__device__ __forceinline__ int product_ks(const Ring& rn, int N, int K, int ks_max) {
  return da_tiling(rn.sub, N, ks_max, min(rn.boxes * DA_BOX_K, K) / 4).ks;
}
// the sum of the ks partial tiles of (row r, column col), in order
__device__ __forceinline__ float tile_sum(const float* red, int sub, int N, int ks, int r,
                                          int col) {
  float s = 0.0f;
  for (int k = 0; k < ks; ++k) s += red[((long long)k * sub + r) * N + col];
  return s;
}

// Phase (a) for item (row r, head h) at step t: d_ctx, dw over the item's
// extent, the softmax adjoint dsc, dq_att over K, d_q into the dq stream.
__device__ __forceinline__ void attend_item(const BwdArgs& a, int t, bool first, int r, int h,
                                            int ext, float* region) {
  const int P = a.P, Te = a.Te, heads = a.heads, B = a.B;
  const int d = P / heads, hd = h * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  float* dch_s = region;             // [d]
  float* dw_s = dch_s + d;           // [Te]
  float* wsum_s = dw_s + Te;         // [DA_WARPS]
  float* gsum_s = wsum_s + DA_WARPS; // [groups][d]
  const long long row = (long long)t * B + r;  // this step's row of a (T, B, .) stream
  const float* wrow = wgts + (row * heads + h) * Te;

  // d_ctx = dctx + dctxup[t]: stored, and kept for the product with V
  for (int p = tid; p < d; p += DA_CONSUMERS) {
    const float carry = first ? 0.0f : __ldcg(dctx_c + (long long)r * P + hd + p);
    const float d_ctx = carry + ld_nc(dctxup + row * P + hd + p);
    dctxtot[row * P + hd + p] = d_ctx;
    dch_s[p] = d_ctx;
  }
  named_barrier(1, DA_CONSUMERS);

  // dw[te] = sum_i d_ctx[i] * v[te, hd + i] (+ dwup) below the extent: L
  // adjacent lanes a frame (4, or 2 where d is not a multiple of 16), lane q
  // summing the 16-byte pieces q, q + L, ... of the head's d columns (a
  // frame's lanes read adjacent pieces of V and of d_ctx, without bank
  // conflicts) with up to 16 loads in flight, the frame's weight (and dwup)
  // loaded beside them, the L partial sums added by xor shuffles in a fixed
  // pattern; the frame's first lane keeps dw, its share of sum(dw * w), and
  // the weight in the group sums' memory (free until dq_att) where the Te of
  // them fit, else reads it again below
  const float* vrow = vmat + (long long)r * Te * P + hd;
  const int L = d % 16 == 0 ? 4 : 2, pieces = d / 4;
  const int slices = d / 4, groups = da_att_groups(P, heads, a.att);
  float* w_s = Te <= groups * d ? gsum_s : nullptr;
  float part = 0.0f;
  for (int w0 = warp * 32; w0 < ext * L; w0 += DA_CONSUMERS) {  // warp-uniform trips
    const int w = w0 + lane, te = w / L, q = w % L;
    const bool on = te < ext;
    const float* vp = vrow + (long long)(on ? te : 0) * P + 4 * q;
    const float* cp = dch_s + 4 * q;
    const bool lead = on && q == 0;
    const float wt = lead ? ld_nc(wrow + te) : 0.0f;
    const float up = lead && dwup != nullptr ? ld_nc(dwup + (row * heads + h) * Te + te) : 0.0f;
    float s = 0.0f;
    for (int m0 = 0; m0 < pieces; m0 += 16 * L) {  // this lane's pieces m0 / L + u
      float4 vv[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        vv[u] = on && m0 + L * u + q < pieces
                    ? __ldg(reinterpret_cast<const float4*>(vp + 4 * (m0 + L * u)))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (m0 + L * u + q >= pieces) break;
        const float4 c4 = *reinterpret_cast<const float4*>(cp + 4 * (m0 + L * u));
        s += __fmul_rn(c4.x, vv[u].x);
        s += __fmul_rn(c4.y, vv[u].y);
        s += __fmul_rn(c4.z, vv[u].z);
        s += __fmul_rn(c4.w, vv[u].w);
      }
    }
    for (int o = L / 2; o >= 1; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lead) {
      if (dwup != nullptr) s += up;
      dw_s[te] = s;
      if (w_s != nullptr) w_s[te] = wt;
      part += s * wt;
    }
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
  if (lane == 0) wsum_s[warp] = part;
  named_barrier(1, DA_CONSUMERS);
  float sum = 0.0f;
#pragma unroll
  for (int w = 0; w < DA_WARPS; ++w) sum += wsum_s[w];

  // the softmax adjoint: dsc = w * (dw - sum) below the extent, 0 past it;
  // dsc * scale kept for the product with K
  float* dsc_row = dsc_out + (row * heads + h) * Te;
  for (int te = tid; te < Te; te += DA_CONSUMERS) {
    float dsc = 0.0f;
    if (te < ext) {
      dsc = (w_s != nullptr ? w_s[te] : ld_nc(wrow + te)) * (dw_s[te] - sum);
      dw_s[te] = dsc * a.scale;
    }
    dsc_row[te] = dsc;
  }
  // dqup of the thread's first column, loaded behind dq_att
  const float up0 = tid < d ? ld_nc(dqup + row * P + hd + tid) : 0.0f;
  named_barrier(1, DA_CONSUMERS);

  // dq_att[p] = sum_te dsc_scaled[te] * k[te, hd + p]: thread (group gi,
  // slice sl) sums frames gi, gi + groups, ... below the extent of the four
  // columns of slice sl, sixteen frames' loads in flight; the groups' sums
  // meet in shared memory, added in order
  const float* krow = kmat + (long long)r * Te * P + hd;
  const int gi = tid / slices, p0 = (tid % slices) * 4;
  if (gi < groups) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    constexpr int U = 16;
    for (int te0 = gi; te0 < ext; te0 += U * groups) {
      float kv[U][4];
      float ds[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int te = te0 + u * groups;
        const bool in = te < ext;
        if (in) load16_nc(krow + (long long)te * P + p0, kv[u]);
        else kv[u][0] = kv[u][1] = kv[u][2] = kv[u][3] = 0.0f;
        ds[u] = in ? dw_s[te] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[jj] += __fmul_rn(ds[u], kv[u][jj]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) gsum_s[gi * d + p0 + jj] = acc[jj];
  }
  named_barrier(1, DA_CONSUMERS);
  for (int p = tid; p < d; p += DA_CONSUMERS) {
    float acc = 0.0f;
    for (int k = 0; k < groups; ++k) acc += gsum_s[k * d + p];
    dq[row * P + hd + p] = acc + (p == tid ? up0 : ld_nc(dqup + row * P + hd + p));
  }
}

__global__ void __launch_bounds__(DA_THREADS, 1)
    speller_bwd_kernel(BwdArgs a, const __grid_constant__ BwdMaps maps, unsigned* ctr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P, H1 = a.H1, H2 = a.H2, B = a.B, Te = a.Te, heads = a.heads;
  const int G = gridDim.x, CG = a.cg, R = a.rows, S = a.sub;
  const int cgi = blockIdx.x % CG, rgi = blockIdx.x / CG;
  const int U1 = H1 / CG, U2 = H2 / CG, NQ = P / CG;
  const int u01 = cgi * U1, u02 = cgi * U2, q0 = cgi * NQ;
  const int r_begin = rgi * R, r_end = min(B, r_begin + R);
  const int n_sub = (r_end - r_begin + S - 1) / S;
  const int n_items = B * heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  unsigned char* ring =
      smem_raw + ((DA_ALIGN - (smem_u32(smem_raw) & (DA_ALIGN - 1))) & (DA_ALIGN - 1));
  const int WR = a.stream ? da_wrows(P, H1, CG) : 0;  // (d)'s weight rows a box
  const int stage_bytes = a.boxes * (S + WR) * DA_ROW_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)a.stages * stage_bytes);
  float* wb_s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(bars) +
                                         align16((size_t)a.stages * 16));  // [P][U2]
  float* wc_s = wb_s + (size_t)P * U2;                         // [4 H2][U1 + U2]
  float* wd_s = wc_s + (size_t)4 * H2 * (U1 + U2);             // [4 H1][U1 + NQ]
  float* region = wd_s + (a.stream ? 0 : (size_t)4 * H1 * (U1 + NQ));
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + a.stages);

  if (tid == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, DA_WARPS);  // every consumer warp
    }
    mbar_init_fence();
  }
  unsigned* group_ctr = ctr + N_FIXED_CTRS;
  auto gctr = [&](int g, int c) { return group_ctr + g * N_GROUP_CTRS + c; };
  // the items of a row group
  auto group_items = [&](int g) { return (min(B, g * R + R) - g * R) * heads; };

  // ---- the producer: lane 0 of the last warp fills the ring, in the order
  // the consumers take the stages: each phase's sub-tiles, each sub-tile's
  // stages of `boxes` boxes
  if (warp == DA_WARPS) {
    __syncthreads();
    if (lane == 0) {
      int slot = 0;
      unsigned phase = 0;
      auto await = [&](int c, unsigned target) {
        while (load_acquire(gctr(rgi, c)) < target) {
        }
        fence_proxy_async_global();  // the acquire, then the TMA reads of what it published
      };
      // One phase's stages: each waits for its slot, then its boxes of the
      // input and,
      // with_w, the block's own rows of whh1 and wc1 for the same k. The
      // input waits for counter c to reach `target` (the phase's input
      // published); the weights do not, so the stages whose slots are free
      // first load their weight rows before that wait.
      auto fill = [&](int map, int K, int t, bool with_w, int c, unsigned target) {
        const int n_boxes = (K + DA_BOX_K - 1) / DA_BOX_K;
        const int per_sub = (n_boxes + a.boxes - 1) / a.boxes;
        const int early = with_w ? min(a.stages, per_sub) : 0;
        auto slot_of = [&](int i, int& sl, unsigned& ph) {  // stage i of the phase
          sl = (slot + i) % a.stages;
          ph = phase ^ (((slot + i) / a.stages) & 1);
        };
        auto weights = [&](int sl, int b0, int nb) {
          const uint32_t full = full0 + 8 * sl;
          const uint32_t base = smem_u32(ring) + sl * stage_bytes;
          for (int bx = 0; bx < nb; ++bx) {
            const int k0 = (b0 + bx) * DA_BOX_K;
            const uint32_t wdst = base + (a.boxes * S + bx * WR) * DA_ROW_BYTES;
            tma_load_3d(wdst, &maps.m[M_WHH1], full, k0, u01, 0);
            tma_load_3d(wdst + da_pad8(U1) * DA_ROW_BYTES, &maps.m[M_WC1], full, k0, q0, 0);
          }
        };
        auto claim = [&](int sl, unsigned ph, int nb) {  // the slot, and its bytes
          mbar_wait(empty0 + 8 * sl, ph ^ 1);
          mbar_arrive_expect_tx(full0 + 8 * sl,
                                nb * (S + (with_w ? U1 + NQ : 0)) * DA_ROW_BYTES);
        };
        for (int i = 0; i < early; ++i) {
          int sl;
          unsigned ph;
          slot_of(i, sl, ph);
          const int nb = min(a.boxes, n_boxes - i * a.boxes);
          claim(sl, ph, nb);
          weights(sl, i * a.boxes, nb);
        }
        await(c, target);
        for (int sb = 0; sb < n_sub; ++sb) {
          const int row0 = r_begin + sb * S;
          for (int b0 = 0; b0 < n_boxes; b0 += a.boxes) {
            const int i = sb * per_sub + b0 / a.boxes;
            const int nb = min(a.boxes, n_boxes - b0);
            int sl;
            unsigned ph;
            slot_of(i, sl, ph);
            if (i >= early) {
              claim(sl, ph, nb);
              if (with_w) weights(sl, b0, nb);
            }
            const uint32_t full = full0 + 8 * sl;
            const uint32_t dst = smem_u32(ring) + sl * stage_bytes;
            for (int bx = 0; bx < nb; ++bx)
              tma_load_3d(dst + bx * S * DA_ROW_BYTES, &maps.m[map], full, (b0 + bx) * DA_BOX_K,
                          row0, t);
          }
        }
        const int total = n_sub * per_sub;
        phase ^= ((slot + total) / a.stages) & 1;
        slot = (slot + total) % a.stages;
      };
      for (int s = 0; s < a.T; ++s) {
        const int t = a.T - 1 - s;
        fill(M_DQ, P, t, false, C_ATTEND, (unsigned)(s + 1) * group_items(rgi));
        fill(M_DPRE2, 4 * H2, t, false, C_CELL2, (unsigned)(s + 1) * CG);
        fill(M_DPRE1, 4 * H1, t, a.stream != 0, C_CELL1, (unsigned)(s + 1) * CG);
      }
    }
    __syncwarp();
    return;
  }

  // ---- the consumers
  {
    const float* wc1 = static_cast<const float*>(a.p[P_WC1]);
    const float* whh1 = static_cast<const float*>(a.p[P_WHH1]);
    const float* wih2 = static_cast<const float*>(a.p[P_WIH2]);
    const float* whh2 = static_cast<const float*>(a.p[P_WHH2]);
    const float* wq = static_cast<const float*>(a.p[P_WQ]);
    // this block's weight rows, transposed to [k][column], for the whole launch
    for (int idx = tid; idx < U2 * P; idx += DA_CONSUMERS) {
      const int c = idx / P, k = idx % P;
      wb_s[k * U2 + c] = wq[(long long)(u02 + c) * P + k];
    }
    const int NC = U1 + U2, KC = 4 * H2;
    for (int idx = tid; idx < NC * KC; idx += DA_CONSUMERS) {
      const int c = idx / KC, k = idx % KC;
      wc_s[(long long)k * NC + c] =
          c < U1 ? wih2[(long long)(u01 + c) * KC + k] : whh2[(long long)(u02 + c - U1) * KC + k];
    }
    const int ND = U1 + NQ, KD = 4 * H1;
    for (int idx = tid; !a.stream && idx < ND * KD; idx += DA_CONSUMERS) {
      const int c = idx / KD, k = idx % KD;
      wd_s[(long long)k * ND + c] =
          c < U1 ? whh1[(long long)(u01 + c) * KD + k] : wc1[(long long)(q0 + c - U1) * KD + k];
    }
  }
  __syncthreads();

  // each item's extent: one past its last frame whose weight is non-zero at
  // any step (0 if none), items b, b + G, ...; then the items ranked by it,
  // longest first (ties by item), and placed at their rank
  const float* wgts = static_cast<const float*>(a.p[P_WGTS]);
  int* ext_g = static_cast<int*>(const_cast<void*>(a.p[P_EXT]));
  int* perm = static_cast<int*>(const_cast<void*>(a.p[P_PERM]));
  int* red_i = reinterpret_cast<int*>(region);
  for (int it = blockIdx.x; it < n_items; it += G) {
    int last = -1;  // every load independent of the others, so many in flight
#pragma unroll 8
    for (long long e = tid; e < (long long)a.T * Te; e += DA_CONSUMERS) {
      const int t = (int)(e / Te), te = (int)(e % Te);
      if (ld_nc(wgts + ((long long)t * n_items + it) * Te + te) != 0.0f) last = max(last, te);
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) last = max(last, __shfl_xor_sync(FULL, last, o));
    if (lane == 0) red_i[warp] = last;
    named_barrier(1, DA_CONSUMERS);
    if (tid == 0) {
      int m = -1;
      for (int w = 0; w < DA_WARPS; ++w) m = max(m, red_i[w]);
      ext_g[it] = m + 1;
    }
    named_barrier(1, DA_CONSUMERS);
  }
  auto grid_wait = [&](int c, unsigned target) {  // every block's release of c
    named_barrier(1, DA_CONSUMERS);
    if (tid == 0) {
      __threadfence();
      arrive_release(ctr + c);
      while (load_acquire(ctr + c) < target) {
      }
    }
    named_barrier(1, DA_CONSUMERS);
  };
  grid_wait(C_START, (unsigned)G);
  for (int it = blockIdx.x * DA_CONSUMERS + tid; it < n_items; it += G * DA_CONSUMERS) {
    const int e = __ldcg(ext_g + it);
    int rnk = 0;
    for (int q = 0; q < n_items; ++q) {
      const int eq = __ldcg(ext_g + q);
      rnk += eq > e || (eq == e && q < it);
    }
    perm[rnk] = it;
  }
  grid_wait(C_RANKED, (unsigned)G);

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
  float* dh1_c = static_cast<float*>(const_cast<void*>(a.p[P_DH1]));
  float* dc1_c = static_cast<float*>(const_cast<void*>(a.p[P_DC1]));
  float* dh2_c = static_cast<float*>(const_cast<void*>(a.p[P_DH2]));
  float* dc2_c = static_cast<float*>(const_cast<void*>(a.p[P_DC2]));
  float* dctx_c = static_cast<float*>(const_cast<void*>(a.p[P_DCTX]));

  Ring rng{ring, full0, empty0, stage_bytes, a.stages, a.boxes, S, 0, 0u};
  const int NB_ = U2, NC_ = U1 + U2, ND_ = U1 + NQ;
  const int ks_b = product_ks(rng, NB_, P, a.ks), ks_c = product_ks(rng, NC_, 4 * H2, a.ks),
            ks_d = product_ks(rng, ND_, 4 * H1, a.ks);
  auto position = [&](int m) {  // this block's m-th position in the order
    return m * G + ((m & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  // the end of a phase: the block's stores published through counter c
  auto publish = [&](unsigned* c) {
    fence_proxy_async_global();  // stores read by other blocks' TMA
    named_barrier(1, DA_CONSUMERS);
    if (tid == 0) arrive_release(c);
  };

  for (int s = 0; s < a.T; ++s) {
    const int t = a.T - 1 - s;
    const bool first = s == 0;
    const long long row_t = (long long)t * B;  // this step's rows of a (T, B, .) stream
    DA_STAMP(S_STEP, s);

    // (a): the attention adjoint of the block's items, each after dctx of
    // step s - 1 of its row group
    for (int m = 0; position(m) < n_items; ++m) {
      const int item = __ldcg(perm + position(m));
      const int r = item / heads, h = item % heads, g = r / R;
      if (!first) {
        if (tid == 0) {
          const unsigned target = (unsigned)s * CG;
          while (load_acquire(gctr(g, C_BACK)) < target) {
          }
        }
        named_barrier(1, DA_CONSUMERS);
      }
      if (m == 0) DA_STAMP(S_BACK_ACQUIRED, s);
      attend_item(a, t, first, r, h, __ldcg(ext_g + item), region);
      publish(gctr(g, C_ATTEND));
    }
    DA_STAMP(S_ATTEND_PUBLISHED, s);

    const float* m2_t = m2 != nullptr ? m2 + row_t * H2 : nullptr;
    const float* m1_t = m1 != nullptr ? m1 + row_t * H1 : nullptr;
    const float* c2_prev = t == 0 ? c20 : c2 + (row_t - B) * H2;
    const float* c1_prev = t == 0 ? c10 : c1 + (row_t - B) * H1;

    // (b): d_q @ wq^T over the block's cell-2 units, their gate adjoint
    for (int sb = 0; sb < n_sub; ++sb) {
      const int r0 = r_begin + sb * S, n = min(S, r_end - r0);
      for (int p = tid; p < n * NB_; p += DA_CONSUMERS)
        prefetch_gate(gates2 + row_t * 4 * H2, c2 + row_t * H2, c2_prev, m2_t, r0 + p / NB_, H2,
                      u02 + p % NB_);
      run_product(rng, wb_s, NB_, P, a.ks, region, sb == 0 ? S_B_INPUT : -1, s);
      for (int p = tid; p < n * NB_; p += DA_CONSUMERS) {
        const int rr = p / NB_, col = p % NB_, row = r0 + rr, u = u02 + col;
        const float sum = tile_sum(region, S, NB_, ks_b, rr, col);
        const float dh = first ? 0.0f : dh2_c[(long long)row * H2 + u];
        gate_adjoint(gates2 + row_t * 4 * H2, c2 + row_t * H2, c2_prev, m2_t,
                     dpre2 + row_t * 4 * H2, dc2_c, first, row, H2, u, dh + sum);
      }
      named_barrier(1, DA_CONSUMERS);  // the partial tiles are read
    }
    publish(gctr(rgi, C_CELL2));
    DA_STAMP(S_B_PUBLISHED, s);

    // (c): dpre2 @ [wih2; whh2]^T: cell 1's gate adjoint and the new dh2
    for (int sb = 0; sb < n_sub; ++sb) {
      const int r0 = r_begin + sb * S, n = min(S, r_end - r0);
      for (int p = tid; p < n * U1; p += DA_CONSUMERS)
        prefetch_gate(gates1 + row_t * 4 * H1, c1 + row_t * H1, c1_prev, m1_t, r0 + p / U1, H1,
                      u01 + p % U1);
      run_product(rng, wc_s, NC_, 4 * H2, a.ks, region, sb == 0 ? S_C_INPUT : -1, s);
      for (int p = tid; p < n * NC_; p += DA_CONSUMERS) {
        const int rr = p / NC_, col = p % NC_, row = r0 + rr;
        const float sum = tile_sum(region, S, NC_, ks_c, rr, col);
        if (col < U1) {
          const int u = u01 + col;
          const float dh = first ? 0.0f : dh1_c[(long long)row * H1 + u];
          gate_adjoint(gates1 + row_t * 4 * H1, c1 + row_t * H1, c1_prev, m1_t,
                       dpre1 + row_t * 4 * H1, dc1_c, first, row, H1, u, dh + sum);
        } else {
          dh2_c[(long long)row * H2 + u02 + col - U1] = sum;
        }
      }
      named_barrier(1, DA_CONSUMERS);
    }
    publish(gctr(rgi, C_CELL1));
    DA_STAMP(S_C_PUBLISHED, s);

    // (d): dpre1 @ [whh1; wc1]^T: the new dh1 and the block's columns of dctx
    for (int sb = 0; sb < n_sub; ++sb) {
      const int r0 = r_begin + sb * S, n = min(S, r_end - r0);
      run_product(rng, a.stream ? nullptr : wd_s, ND_, 4 * H1, a.ks, region,
                  sb == 0 ? S_D_INPUT : -1, s, U1, WR);
      for (int p = tid; p < n * ND_; p += DA_CONSUMERS) {
        const int rr = p / ND_, col = p % ND_, row = r0 + rr;
        const float sum = tile_sum(region, S, ND_, ks_d, rr, col);
        if (col < U1)
          dh1_c[(long long)row * H1 + u01 + col] = sum;
        else
          dctx_c[(long long)row * P + q0 + col - U1] = sum;
      }
      named_barrier(1, DA_CONSUMERS);
    }
    publish(gctr(rgi, C_BACK));
    DA_STAMP(S_D_PUBLISHED, s);
  }
}

// The geometry this body takes (ops/speller_cuda.py::plan_decode_bwd_f32
// checks it first, with the limits below).
static bool geometry_ok(const BwdArgs& a) {
  if (a.B < 1 || a.Te < 1 || a.T < 1 || a.heads < 1) return false;
  if (a.cg < 1 || a.rg < 1 || a.cg * a.rg > DA_MAX_GRID || a.rows < 1 ||
      (a.B + a.rows - 1) / a.rows != a.rg)
    return false;
  if (a.P % a.cg || a.H1 % a.cg || a.H2 % a.cg || a.P % 8 || a.H1 % 8 || a.H2 % 8) return false;
  if (a.P % a.heads || (a.P / a.heads) % 8 || a.P / a.heads / 4 > DA_CONSUMERS) return false;
  if (a.sub < 8 || a.sub % 8 || a.sub > DA_MAX_BOX_ROWS) return false;
  if (a.boxes < 1 || a.boxes > DA_MAX_BOXES || a.stages < 1 || a.stages > DA_MAX_STAGES ||
      a.ks < 1 || a.ks > DA_MAX_KS || a.att < 1)
    return false;
  if (a.stream && (a.H1 / a.cg > DA_MAX_BOX_ROWS || a.P / a.cg > DA_MAX_BOX_ROWS)) return false;
  const int cols[3] = {a.H2 / a.cg, a.H1 / a.cg + a.H2 / a.cg, a.H1 / a.cg + a.P / a.cg};
  for (int i = 0; i < 3; ++i)
    if (da_tiling(a.sub, cols[i], a.ks, 1).tiles > DA_CONSUMERS) return false;
  return true;
}

// the map of a (T, B, X) fp32 stream: boxes of DA_LDX columns x `rows` rows x
// one step, unswizzled (a box lands as rows of DA_LDX floats: the 4 past
// DA_BOX_K pad the staged rows, so a warp's rows fall in other banks); rows and
// columns past the tensor read as zeros (a weight (B rows, X) with T = 1)
static bool encode_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, int X, int B,
                       int T, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)X, (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)X * 4, (cuuint64_t)X * 4 * B};
  const cuuint32_t box[3] = {DA_LDX, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The constants the plan (ops/speller_cuda.py, BWD_F32_LIMITS) mirrors, the
// shared memory a block of `device` may opt into and its SMs: out =
// {DA_MAX_GRID, DA_CONSUMERS, DA_BOX_K, DA_LDX, DA_MAX_BOXES, DA_MAX_STAGES,
// DA_MAX_KS, DA_MAX_BOX_ROWS, DA_ALIGN, optin, sms}. Returns a cudaError_t (0
// on success).
extern "C" int speller_bwd_limits(int device, long long* out) {
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long vals[] = {DA_MAX_GRID,   DA_CONSUMERS, DA_BOX_K,        DA_LDX,   DA_MAX_BOXES,
                            DA_MAX_STAGES, DA_MAX_KS,    DA_MAX_BOX_ROWS, DA_ALIGN, optin,
                            sms};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return (int)err;
}

// dims: N_DIMS ints (enum Dim), geom: N_GEOM ints (enum GeomSlot): the shared
// memory a block of that launch uses (da_smem_bytes), for a card test of the
// plan's formula
extern "C" size_t speller_bwd_smem_bytes(const int* dims, const int* geom) {
  return da_smem_bytes(dims[D_TE], dims[D_P], dims[D_HEADS], dims[D_H1], dims[D_H2], geom[G_CG],
                       geom[G_SUB], geom[G_BOXES], geom[G_STAGES], geom[G_KS], geom[G_ATT],
                       geom[G_STREAM]);
}

// One launch of the whole batch. ptrs: N_PTRS device pointers in enum Ptr
// order (P_M1, P_M2 and P_DWUP may be null); dims: N_DIMS ints in enum Dim
// order; geom: N_GEOM ints in enum GeomSlot order (the plan's); ctr:
// N_FIXED_CTRS + N_GROUP_CTRS x row groups zeroed counters. What the
// geometry check refuses returns cudaErrorInvalidValue. Returns a
// cudaError_t (0 on success).
extern "C" int speller_bwd_launch(const void* const* ptrs, const int* dims, const int* geom,
                                  float scale, void* ctr, void* stream) {
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
  a.cg = geom[G_CG];
  a.rg = geom[G_RG];
  a.rows = geom[G_ROWS];
  a.sub = geom[G_SUB];
  a.boxes = geom[G_BOXES];
  a.stages = geom[G_STAGES];
  a.ks = geom[G_KS];
  a.att = geom[G_ATT];
  a.stream = geom[G_STREAM];
  if (!geometry_ok(a)) return (int)cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  BwdMaps maps;
  if (!encode_map(encode, &maps.m[M_DQ], a.p[P_DQ], a.P, a.B, a.T, a.sub) ||
      !encode_map(encode, &maps.m[M_DPRE2], a.p[P_DPRE2], 4 * a.H2, a.B, a.T, a.sub) ||
      !encode_map(encode, &maps.m[M_DPRE1], a.p[P_DPRE1], 4 * a.H1, a.B, a.T, a.sub))
    return (int)cudaErrorInvalidValue;
  if (a.stream &&
      (!encode_map(encode, &maps.m[M_WHH1], a.p[P_WHH1], 4 * a.H1, a.H1, 1, a.H1 / a.cg) ||
       !encode_map(encode, &maps.m[M_WC1], a.p[P_WC1], 4 * a.H1, a.P, 1, a.P / a.cg)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = da_smem_bytes(a.Te, a.P, a.heads, a.H1, a.H2, a.cg, a.sub, a.boxes,
                                    a.stages, a.ks, a.att, a.stream);
  cudaError_t err = cudaFuncSetAttribute(speller_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3(a.cg * a.rg);
  cfg.blockDim = dim3(DA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  unsigned* c = static_cast<unsigned*>(ctr);
  void* params[] = {&a, &maps, &c};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(speller_bwd_kernel), params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
