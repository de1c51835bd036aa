// Adjoint of the persistent LSTM recurrence (lstm_scan.cu, TRAIN = true) for
// Hopper (sm_90a), float32: one cooperative launch walks the whole time loop
// of one listener layer backwards, for every batch row the card holds at
// once and one or both directions (bfloat16 is lstm_bwd_tc.cu's, on tensor
// cores). Two forms of one kernel:
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
// both products, sums are fp32, carries fp32, plain fmaf on the CUDA cores (no
// TF32: float32's tolerance). A padded frame is an exact no-op (dpre = 0,
// carries unchanged). The scan's first frame pairs with h = 0 and adds
// nothing to dW_hh.
//
// What bounds it on this card. Every step of a (direction, row group) waits
// for the previous step's dpre from every block of that group, and each block
// needs all 4H columns of it for its rows, so a step costs the wait, the
// exchange's L2 reads and the block's share of dh_prev = dpre @ W_hh^T:
//   * H = 512, B = 128, both directions (one launch of 128 blocks, R = 64 rows
//     x U = 16 units a block): R x U x 4H = 2.1M FMAs a block a step (~8.3 us
//     at the SM's 128 a clock, 1.98 GHz), 512 KB of exchange a block, 64 MB a
//     step over the L2;
//   * H = 1024, B = 128 (a launch a direction: U = 8 by shared memory, W_hh's
//     rows 128 KB, so R = 128 and 128 blocks): 4.2M FMAs a block (~16.6 us)
//     and 2 MB of exchange a block, 256 MB a step per direction.
// dW_hh (WITH_DW) is as many FMAs again, H x 4U x R a block a frame. On the
// card the step came out bound by neither: each ring stage of a step cost a
// fixed time beyond its FMAs and bytes, whatever fed it (cp.async under block
// barriers, per-warp rings, TMA with mbarriers; PERF.md has the times), so
// the design takes as few, as wide stages as the shared memory allows, and
// skips what padding makes an exact no-op.
//
// Design.
//   * Geometry (ops/lstm_cuda.py::_plan_bwd_f32 picks R, U, the ring's
//     stages and their width kc): a block owns R batch rows x U hidden units
//     of one direction and keeps those units' rows of W_hh (U x 4H fp32, each
//     padded by B32_WPAD floats) in shared memory for the whole sequence.
//     Every row group and both directions are in one cooperative launch
//     wherever their blocks fit the SMs, one block an SM.
//   * Synchronisation: one acquire/release counter a (direction, row group),
//     as the float32 forward (lstm_scan_body.cuh); directions and row groups
//     never wait for each other. The exchange is a compact double buffer
//     (2, directions, rows, 4H) fp32 beside the dpre output, read by TMA
//     through a tensor map encoded at each launch.
//   * Padding: the block orders its group's rows by length, longest first
//     (every block of the group the same order), and the exchange holds rows
//     by that position, so the rows valid at a frame are a prefix. A step
//     stages, multiplies and sums only the rows valid at t_last (a padded
//     frame's dpre is exactly 0 and dh passes through).
//   * The ring: stages of the valid rows x kc columns (128 at H = 512, 64 at
//     H = 1024; a step whose valid rows fit half a stage takes twice the
//     columns a stage), filled by TMA boxes of up to B32_BOX_ROWS rows that
//     complete on the stage's mbarrier; the last warp done with a stage (a
//     counter in shared memory) refills it with the step's next chunk.
//   * The product: a thread (k lane s of 16, unit tile ug, row tile rt) owns
//     a register tile of B32_RT = 8 rows (rt + i R / 8) x B32_UT = 8 units
//     (8 ug + j) and sums it over the 16-byte pieces s, s + 16, ... of every
//     staged chunk; the 16 lanes' partial sums meet by a butterfly of xor
//     shuffles that halves what a lane keeps at each level, in a fixed order
//     (no shared memory, no atomics: two calls repeat bit for bit). 8 x 8
//     cells a thread read 16 float4 for 256 FMAs (4 x 4 read 8 for 64, which
//     the shared memory could not feed); the split keeps R x U / 4 threads.
//   * The cells: after the sums, lane s keeps row s / 2 of its tile and units
//     4 (s % 2) .. + 3: its gates, carries and output gradient are float4
//     loads issued before the wait for the counter, its dpre four float4
//     stores to the output and to the exchange.
//   * dW_hh (WITH_DW) is off the critical path: after the time loop, in the
//     same launch, each block forms its own 4U columns of dW_hh as one tiled
//     product over every (row, frame) pair of its rows that has a
//     scan-previous frame below the row's length (padded frames add exactly
//     nothing and are skipped). A stage is up to B32_DW_PAIRS consecutive
//     frames of one row: its hs rows at the scan-previous frames and its own
//     dpre columns, a few TMA boxes of 3-D and 4-D tensor maps; a thread holds
//     16 x 8 of the (H, 4U) tile in registers. Row groups' partial sums are
//     added by the wrapper in a fixed order. The time loop is the same code in
//     both forms, so lstm_bwd's dpre is bit-equal to lstm_bwd_dw's.

#include <stdint.h>

#include "lstm_common.cuh"
#include "wgmma_common.cuh"  // smem_u32, arrive_release, load_acquire

constexpr int B32_RT = 8;             // batch rows of a thread's product tile
constexpr int B32_UT = 8;             // hidden units of a thread's product tile
constexpr int B32_KS = 16;            // lanes that split a tile's k range
constexpr int B32_MAX_THREADS = 256;  // (R / 8) x (U / 8) x 16 = R x U / 4, at most
constexpr int B32_KC = 64;            // a narrow ring stage's columns (a plan's kc: 1 or 2 x)
constexpr int B32_MAX_STAGES = 6;     // ring stages, at most (also the dW ring's)
constexpr int B32_BOX_ROWS = 64;      // rows of dpre a tensor-map box holds, at most
constexpr int B32_WPAD = 4;           // floats after a unit's row of W_hh
constexpr int B32_DW_PAIRS = 16;      // (row, frame) pairs a dW stage holds

struct BwdArgs {
  const float* gates;   // (B, T, ndir*4H) activated gates
  const float* cs;      // (B, T, ndir*H) carry c after each frame
  const float* hs;      // (B, T, ndir*H) forward outputs, zero at pads (WITH_DW)
  const float* dy;      // (B, T, ndir*H) gradient of hs
  const float* w_hh;    // (ndir, H, 4H)
  const int* lengths;   // (B,)
  float* dpre;          // out (B, T, ndir*4H)
  float* xbuf;          // (2, launch directions, row groups x R, 4H) the exchange
  float* dw;            // out (row groups, ndir, H, 4H) partial sums (WITH_DW)
  int ndir, rev_bits, B, T, H;  // ndir: directions side by side in the tensors
  int dir0;                     // the launch runs directions dir0 on
};

// Phase stamps for tools/trace_lstm_bwd.py. Built with -DB32_TRACE, thread 0
// of blocks 0 and G - 1 writes %globaltimer at each phase boundary of the
// first B32_TRACE_STEPS steps (and, WITH_DW, the dW product's start and end);
// without it B32_STAMP is nothing and the kernels are the same.
enum Stamp { S_STEP, S_ACQUIRED, S_FIRST_CHUNK, S_PRODUCT, S_CELLS, S_PUBLISHED, N_STAMPS };
#ifdef B32_TRACE
constexpr int B32_TRACE_STEPS = 2048;
__device__ unsigned long long b32_trace[2][N_STAMPS][B32_TRACE_STEPS];
__device__ unsigned long long b32_trace_dw[2][2];
__device__ __forceinline__ unsigned long long b32_now() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}
__device__ __forceinline__ int b32_traced_block() {
  return blockIdx.x == 0 ? 0 : blockIdx.x == gridDim.x - 1 ? 1 : -1;
}
__device__ __forceinline__ void b32_stamp(int e, int s) {
  const int b = b32_traced_block();
  if (b < 0 || s >= B32_TRACE_STEPS || threadIdx.x != 0) return;
  b32_trace[b][e][s] = b32_now();
}
__device__ __forceinline__ void b32_stamp_dw(int e) {
  const int b = b32_traced_block();
  if (b >= 0 && threadIdx.x == 0) b32_trace_dw[b][e] = b32_now();
}
// the stamps, (2, N_STAMPS, B32_TRACE_STEPS) then (2, 2) uint64 nanoseconds
// (0: not written), into `out`; then zeroed
extern "C" int lstm_bwd_trace(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, b32_trace, sizeof(b32_trace));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(static_cast<char*>(out) + sizeof(b32_trace), b32_trace_dw,
                               sizeof(b32_trace_dw));
  void* p = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, b32_trace);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(b32_trace));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, b32_trace_dw);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(b32_trace_dw));
  return (int)err;
}
#define B32_STAMP(e, s) b32_stamp(e, s)
#define B32_STAMP_DW(e) b32_stamp_dw(e)
#else
#define B32_STAMP(e, s)
#define B32_STAMP_DW(e)
#endif

// TMA: one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void b32_tma_load_4d(uint32_t dst, const void* tmap, uint32_t bar,
                                                int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a compile-time count, handed to a generic lambda
template <int V>
struct Span {
  static constexpr int value = V;
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// A warp (its lane 0, after __syncwarp) is done with a ring stage: counts it
// on the stage's counter (acquire-release in the block) and returns whether
// it was the last of the block's warps, then resetting the counter for the
// stage's next fill.
__device__ __forceinline__ bool release(unsigned* ctr) {
  unsigned done;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
               : "=r"(done)
               : "r"(smem_u32(ctr))
               : "memory");
  if (done + 1 < blockDim.x / 32) return false;
  *ctr = 0;
  return true;
}

// Shared memory of a block (ops/lstm_cuda.py::f32_bwd_smem_bytes mirrors it).
// First B32_HEAD_FLOATS of the rings' bookkeeping: an mbarrier a stage of the
// time loop's ring and of the dW ring, that the stage's copies complete on,
// then a counter a stage of each ring, of the warps done with it (the last
// refills it), and the pairs of each dW stage; 256 bytes so that what follows
// is 128-byte aligned. Then, in
// the time loop: W_hh's rows
// [U][4H + B32_WPAD]; the ring, `stages` x R rows x `kc` (B32_KC or twice that); the
// group's rows in order of length, longest first, and their lengths, [2][R]
// ints. After it, WITH_DW, the same memory holds the rows' pair counts
// [R + 1] (rounded up to 4 ints) and the dW ring, stages of B32_DW_PAIRS x
// (H + 4U) floats: at least two, as many as fit the time loop's memory up to
// B32_MAX_STAGES.
constexpr int B32_HEAD_FLOATS = 64;
static_assert(B32_MAX_STAGES * (2 * 8 + 2 * 4 + 4) <= 4 * B32_HEAD_FLOATS,
              "the rings' bookkeeping");
__host__ __device__ inline int b32_threads(int R, int U) {
  return R / B32_RT * (U / B32_UT) * B32_KS;
}
__host__ __device__ inline size_t b32_loop_floats(int H, int U, int R, int stages, int kc) {
  return B32_HEAD_FLOATS + (size_t)U * (4 * H + B32_WPAD) + (size_t)stages * R * kc + 2 * R;
}
// the row's stage counts, R + 1 ints rounded up to 128 bytes (the dW ring's
// TMA boxes land 128-byte aligned)
__host__ __device__ inline size_t b32_pre_floats(int R) { return (size_t)((R + 32) & ~31); }
__host__ __device__ inline size_t b32_dw_stage_floats(int H, int U) {
  return (size_t)B32_DW_PAIRS * (H + 4 * U);
}
__host__ __device__ inline size_t b32_smem_bytes(int H, int U, int R, int stages, int kc,
                                                 bool with_dw) {
  size_t floats = b32_loop_floats(H, U, R, stages, kc);
  if (with_dw) {
    const size_t dw = B32_HEAD_FLOATS + b32_pre_floats(R) + 2 * b32_dw_stage_floats(H, U);
    if (dw > floats) floats = dw;
  }
  return floats * sizeof(float);
}
__host__ __device__ inline int b32_dw_stages(int H, int U, int R, int stages, int kc) {
  const size_t room = b32_smem_bytes(H, U, R, stages, kc, true) / sizeof(float) - B32_HEAD_FLOATS -
                      b32_pre_floats(R);
  const int n = (int)(room / b32_dw_stage_floats(H, U));
  return n < B32_MAX_STAGES ? n : B32_MAX_STAGES;
}

// a.B rows in groups of `rows`; grid (directions x row groups x H / units)
// blocks, block (dl, rg, j) = (dl * RG + rg) * (H / units) + j; sync: one
// zeroed counter a (launch direction, row group)
template <bool WITH_DW>
__global__ void __launch_bounds__(B32_MAX_THREADS, 1)
    lstm_bwd_kernel(BwdArgs a, const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap hmap,
                    const __grid_constant__ CUtensorMap pmap, int units, int rows, int stages,
                    int kc, unsigned* sync) {
  extern __shared__ __align__(128) float smem[];  // TMA boxes land 128-byte aligned
  const int H = a.H, B = a.B, seq_len = a.T, G = 4 * H, U = units, R = rows;
  const int bpg = H / U;  // blocks of a (direction, row group)
  const int n_groups = (B + R - 1) / R;
  const int nd = gridDim.x / (bpg * n_groups);
  const int group = blockIdx.x / bpg;  // dl * n_groups + rg
  const int dl = group / n_groups, rg = group % n_groups;
  const int d = a.dir0 + dl;
  const int u0 = (blockIdx.x % bpg) * U, r0 = rg * R;
  const bool rev = (a.rev_bits >> d) & 1;  // the forward scan walked time descending
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid % 32, warp = tid / 32;
  const int s = tid % B32_KS, x = tid / B32_KS;  // k lane; tile
  const int ug = x % (U / B32_UT), rt = x / (U / B32_UT);
  const int rstride = R / B32_RT;  // the tile's rows: rt + i * rstride
  // the cells of lane s after the sums: the tile's row s / 2, units 4 (s % 2) + j
  constexpr int CU = B32_RT * B32_UT / B32_KS;
  const int LDX = kc;  // a staged row
  const int box_rows = R < B32_BOX_ROWS ? R : B32_BOX_ROWS;
  const int LDW = G + B32_WPAD;

  // the rings' bookkeeping: a stage's mbarrier (its copies complete on it),
  // and its counter of the warps done with it
  const uint32_t bars = smem_u32(smem);
  auto full_bar = [&](int i) { return bars + 8 * i; };
  auto dw_full_bar = [&](int i) { return bars + 8 * (B32_MAX_STAGES + i); };
  unsigned* done_ctr = reinterpret_cast<unsigned*>(smem) + 4 * B32_MAX_STAGES;
  unsigned* dw_done_ctr = done_ctr + B32_MAX_STAGES;
  int* dw_pairs = reinterpret_cast<int*>(dw_done_ctr + B32_MAX_STAGES);  // a dW stage's pairs
  if (tid == 0) {
    for (int i = 0; i < B32_MAX_STAGES; ++i) {
      mbar_init(full_bar(i), 1);
      mbar_init(dw_full_bar(i), 1);
      done_ctr[i] = dw_done_ctr[i] = 0;
    }
    mbar_init_fence();
  }
  float* w_s = smem + B32_HEAD_FLOATS;
  float* ring = w_s + U * LDW;
  int* order = reinterpret_cast<int*>(ring + stages * R * LDX);  // row at each position
  int* order_len = order + R;                                    // its length

  // the group's rows by length, longest first (ties by row): the rows valid
  // at a frame are then positions 0 .. n - 1, and every block of the group
  // computes the same order. Rows past B have length 0.
  for (int r = tid; r < R; r += nthreads) order_len[r] = r0 + r < B ? a.lengths[r0 + r] : 0;
  __syncthreads();
  int my_len = 0, my_rank = 0;
  if (tid < R) {
    my_len = order_len[tid];
    for (int q = 0; q < R; ++q) {
      const int l = order_len[q];
      my_rank += l > my_len || (l == my_len && q < tid);
    }
  }
  __syncthreads();
  if (tid < R) {
    order[my_rank] = tid;
    order_len[my_rank] = my_len;
  }

  // the rows of W_hh of the block's units: w_s[u][k] = W_hh[u0 + u][k]
  const float* w_hh = a.w_hh + (long long)d * H * G;
  for (int idx = tid; idx < U * (G / 4); idx += nthreads) {
    const int u = idx / (G / 4), q = idx % (G / 4);
    *reinterpret_cast<float4*>(w_s + u * LDW + 4 * q) =
        ldg4(w_hh + (long long)(u0 + u) * G + 4 * q);
  }

  __syncthreads();  // the mbarriers, the weights and the order are in shared memory
  // the rows at or past position n(t) of the order are padded at frame t
  auto n_valid = [&](int t) {
    int lo = 0, hi = R;  // the first position whose length is at most t
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (order_len[mid] > t) lo = mid + 1; else hi = mid;
    }
    return lo;
  };

  // the cells: position lp of the order (row rr) and units cu .. cu + 3
  const int lp = rt + rstride * (s / 2), rr = r0 + order[lp];
  const bool live = rr < B;
  const int len = order_len[lp];
  const int cu = u0 + B32_UT * ug + CU * (s % 2);
  float dh[CU], dc[CU];
#pragma unroll
  for (int j = 0; j < CU; ++j) dh[j] = dc[j] = 0.0f;
  bool m_last = false;  // whether the adjoint's previous step was a valid frame

  // contiguous (B, T, ndir*H) and (B, T, ndir*4H) tensors
  const long long sb_h = (long long)seq_len * a.ndir * H, st_h = (long long)a.ndir * H;
  const long long sb_g = (long long)seq_len * a.ndir * G, st_g = (long long)a.ndir * G;
  const float* gates = a.gates + (long long)d * G;
  const float* cs = a.cs + (long long)d * H;
  const float* dy = a.dy + (long long)d * H;
  float* dpre = a.dpre + (long long)d * G;
  const long long rows_pad = (long long)n_groups * R;
  const long long xhalf = (long long)nd * rows_pad * G;
  float* xgroup = a.xbuf + ((long long)dl * rows_pad + r0) * G;  // + half * xhalf, by position
  unsigned* ctr = sync + group;
  unsigned chunks = 0;  // ring chunks consumed so far: stage and phase of the next

  for (int step = 0; step < seq_len; ++step) {
    B32_STAMP(S_STEP, step);
    const int t = rev ? step : seq_len - 1 - step;
    const bool has_prev = rev ? (t + 1 < seq_len) : (t > 0);
    const int t_prev = rev ? t + 1 : t - 1;  // the forward scan's previous frame
    const bool valid = live && t < len;

    // 0. this frame's saved values (independent of the recurrence)
    float4 gi = make_float4(0.f, 0.f, 0.f, 0.f), gf = gi, gg = gi, go = gi, c_t = gi, c_p = gi,
           dy_v = gi;
    if (valid) {
      const float* grow = gates + rr * sb_g + t * st_g + cu;
      gi = ldg4(grow);
      gf = ldg4(grow + H);
      gg = ldg4(grow + 2 * H);
      go = ldg4(grow + 3 * H);
      const long long off_h = rr * sb_h + t * st_h + cu;
      c_t = ldg4(cs + off_h);
      dy_v = ldg4(dy + off_h);
      if (has_prev) c_p = ldg4(cs + rr * sb_h + t_prev * st_h + cu);
    }

    // 1. dh_prev of the adjoint's previous step: dpre[t_last] @ W_hh^T
    if (step > 0) {
      if (tid == 0) {
        const unsigned target = (unsigned)step * bpg;
        while (load_acquire(ctr) < target) {
        }
      }
      __syncthreads();  // every thread is past the acquire before this step's stores
      B32_STAMP(S_ACQUIRED, step);
      // the positions valid at t_last: their dpre is the product's input, and
      // only they take its result (a padded frame leaves dh as it was)
      const int n_rows = n_valid(rev ? t - 1 : t + 1);
      const int ni = n_rows > rt ? min(B32_RT, (n_rows - rt + rstride - 1) / rstride) : 0;
      const int n_boxes = (n_rows + box_rows - 1) / box_rows;
      // a step whose valid rows fit half the group stages twice the columns
      // a chunk: a stage is then [2][R / 2][kc], two column boxes a row box
      const bool wide = 2 * n_rows <= R && 2 * box_rows <= R && 2 * kc <= 256 && G % (2 * kc) == 0;
      const int kcs = wide ? 2 * kc : kc, n_chunks = G / kcs;
      const int hoff = wide ? (R / 2 - 1) * kc : 0;  // to a column past kc of a staged row
      const int half = ((step - 1) & 1) * nd + dl;  // the exchange's outer index read
      // one thread fills ring stage `chunk % stages` (the ring's chunk count
      // `chunk`) with chunk `cc` of this step: boxes of box_rows rows x
      // kc columns by TMA
      auto issue = [&](int cc, unsigned chunk) {
        const int slot = chunk % stages;
        mbar_arrive_expect_tx(full_bar(slot), n_boxes * box_rows * kcs * 4);
        for (int h = 0; h < kcs / kc; ++h)
          for (int b = 0; b < n_boxes; ++b)
            tma_load_3d(smem_u32(ring + (slot * R + h * (R / 2) + b * box_rows) * LDX), &xmap,
                        full_bar(slot), cc * kcs + h * kc, r0 + b * box_rows, half);
      };
      float acc[B32_RT][B32_UT];
#pragma unroll
      for (int i = 0; i < B32_RT; ++i)
#pragma unroll
        for (int j = 0; j < B32_UT; ++j) acc[i][j] = 0.0f;
      // the tile's first NI rows (the others are padded at t_last) over this
      // lane's 16-byte pieces of the chunk, s and s + 16, ...
      auto product = [&](const float* st, const float* wc, auto rows_c) {
        constexpr int NI = decltype(rows_c)::value;
#pragma unroll
        for (int q = 4 * s; q < kcs; q += 4 * B32_KS) {
          const float* sq = st + q + (q >= kc ? hoff : 0);
          float4 dv[NI];
#pragma unroll
          for (int i = 0; i < NI; ++i)
            dv[i] = *reinterpret_cast<const float4*>(sq + i * rstride * LDX);
#pragma unroll
          for (int j = 0; j < B32_UT; ++j) {
            const float4 w = *reinterpret_cast<const float4*>(wc + j * LDW + q);
#pragma unroll
            for (int i = 0; i < NI; ++i) {
              acc[i][j] = fmaf(dv[i].x, w.x, acc[i][j]);
              acc[i][j] = fmaf(dv[i].y, w.y, acc[i][j]);
              acc[i][j] = fmaf(dv[i].z, w.z, acc[i][j]);
              acc[i][j] = fmaf(dv[i].w, w.w, acc[i][j]);
            }
          }
        }
      };
      if (n_rows > 0) {  // the same for every thread of the block
        if (tid == 0) {  // every stage is free: every warp is past this step's acquire
          fence_proxy_async_global();  // the acquired dpre, read by the copy engine
          for (int c = 0; c < stages && c < n_chunks; ++c) issue(c, chunks + c);
        }
        for (int c = 0; c < n_chunks; ++c, ++chunks) {
          const int slot = chunks % stages;
          mbar_wait(full_bar(slot), (chunks / stages) & 1);
          if (c == 0) B32_STAMP(S_FIRST_CHUNK, step);
          const float* st = ring + slot * R * LDX + rt * LDX;
          const float* wc = w_s + (B32_UT * ug) * LDW + c * kcs;
          switch (ni) {
            case 8: product(st, wc, Span<8>()); break;
            case 7: product(st, wc, Span<7>()); break;
            case 6: product(st, wc, Span<6>()); break;
            case 5: product(st, wc, Span<5>()); break;
            case 4: product(st, wc, Span<4>()); break;
            case 3: product(st, wc, Span<3>()); break;
            case 2: product(st, wc, Span<2>()); break;
            case 1: product(st, wc, Span<1>()); break;
            default: break;
          }
          // the last warp done with the stage refills it with chunk c + stages
          __syncwarp();
          if (lane == 0 && release(done_ctr + slot) && c + stages < n_chunks) {
            fence_proxy_async();  // the warps' reads of the stage before the copy engine's writes
            issue(c + stages, chunks + stages);
          }
        }
      }
      // the 16 k lanes' partial sums, a butterfly that halves what a lane
      // keeps at each level (a fixed order: the same bits every call): rows
      // by bits 3, 2, 1 of the lane, then units by bit 0
      float r1[4][B32_UT], r2[2][B32_UT], r3[B32_UT], mine[CU];
      const bool b3 = s & 8, b2 = s & 4, b1 = s & 2, b0 = s & 1;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < B32_UT; ++j)
          r1[i][j] = (b3 ? acc[i + 4][j] : acc[i][j]) +
                     __shfl_xor_sync(0xffffffffu, b3 ? acc[i][j] : acc[i + 4][j], 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < B32_UT; ++j)
          r2[i][j] = (b2 ? r1[i + 2][j] : r1[i][j]) +
                     __shfl_xor_sync(0xffffffffu, b2 ? r1[i][j] : r1[i + 2][j], 4);
#pragma unroll
      for (int j = 0; j < B32_UT; ++j)
        r3[j] = (b1 ? r2[1][j] : r2[0][j]) +
                __shfl_xor_sync(0xffffffffu, b1 ? r2[0][j] : r2[1][j], 2);
#pragma unroll
      for (int j = 0; j < CU; ++j)
        mine[j] = (b0 ? r3[j + CU] : r3[j]) +
                  __shfl_xor_sync(0xffffffffu, b0 ? r3[j] : r3[j + CU], 1);
      B32_STAMP(S_PRODUCT, step);
      if (m_last) {  // a padded frame leaves dh as it was
#pragma unroll
        for (int j = 0; j < CU; ++j) dh[j] = mine[j];
      }
    }

    // 2. this frame's dpre and the dc carry for row rr, units cu .. cu + 3
    float dp[4][CU];
#pragma unroll
    for (int j = 0; j < CU; ++j) {
      dp[0][j] = dp[1][j] = dp[2][j] = dp[3][j] = 0.0f;
      if (valid) {
        const float i_ = comp(gi, j), f_ = comp(gf, j), g_ = comp(gg, j), o_ = comp(go, j);
        const float tanh_ct = tanhf(comp(c_t, j));
        const float dh_total = comp(dy_v, j) + dh[j];
        const float dc_total = dc[j] + dh_total * o_ * (1.0f - tanh_ct * tanh_ct);
        dp[0][j] = dc_total * g_ * i_ * (1.0f - i_);
        dp[1][j] = dc_total * comp(c_p, j) * f_ * (1.0f - f_);
        dp[2][j] = dc_total * i_ * (1.0f - g_ * g_);
        dp[3][j] = dh_total * tanh_ct * o_ * (1.0f - o_);
        dc[j] = dc_total * f_;  // dh is replaced by dh_prev at the next step
      }
    }
    m_last = valid;
    if (live) {
      float* prow = dpre + rr * sb_g + t * st_g + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) st4(prow + g * H, dp[g]);
    }
    if (step + 1 < seq_len) {
      // 3. publish dpre_t to this group's blocks, by position (rows past B
      //    carry zeros)
      float* xrow = xgroup + (step & 1) * xhalf + (long long)lp * G + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) st4(xrow + g * H, dp[g]);
      B32_STAMP(S_CELLS, step);
      __syncthreads();  // the block's dpre_t is written
      if (tid == 0) arrive_release(ctr);
      B32_STAMP(S_PUBLISHED, step);
    }
  }

  if constexpr (WITH_DW) {
    // 4. dW_hh[:, own columns] = sum over the rows' (row, frame) pairs of
    //    hs[row, t_prev]^T dpre[row, t, own columns], frames below the row's
    //    length with a scan-previous frame, rows in order, frames ascending
    fence_proxy_async();         // shared memory read here before, written by the copy engine next
    fence_proxy_async_global();  // dpre written here, read by the copy engine next
    __syncthreads();             // the time loop is done with shared memory; dpre is written
    B32_STAMP_DW(0);
    // a stage holds up to B32_DW_PAIRS consecutive frames of one row: its hs
    // rows at the scan-previous frames, box by box of HB columns, then its
    // own dpre columns, 4U a frame (gate * U + unit); a row's stages are
    // ceil(pairs / B32_DW_PAIRS), spre[r] of them before row r
    int* spre = reinterpret_cast<int*>(smem + B32_HEAD_FLOATS);
    float* dws = smem + B32_HEAD_FLOATS + b32_pre_floats(R);
    const int dw_stages = b32_dw_stages(H, U, R, stages, kc);
    // frames with a scan-previous frame below the row's length: 1 .. l - 1
    // ascending, 0 .. min(l, T - 1) - 1 descending
    auto pairs_of = [&](int r) {
      const int l = r0 + r < B ? a.lengths[r0 + r] : 0;
      const int n = rev ? min(l, seq_len - 1) : l - 1;
      return n > 0 ? n : 0;
    };
    if (tid == 0) {
      int total = 0;
      for (int r = 0; r < R; ++r) {
        spre[r] = total;
        total += (pairs_of(r) + B32_DW_PAIRS - 1) / B32_DW_PAIRS;
      }
      spre[R] = total;
    }
    __syncthreads();
    const int n_dw = spre[R];
    const int n_hb = (H + 255) / 256, HB = H / n_hb;  // hs boxes a stage, and their columns
    const int stage_floats = B32_DW_PAIRS * (H + 4 * U);
    // the row and first frame of stage c, and its pairs
    auto stage_of = [&](int c, int& row, int& t0, int& n_in) {
      int lo = 0, hi = R - 1;  // the last row with spre[row] <= c
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (spre[mid] <= c) lo = mid; else hi = mid - 1;
      }
      const int j = c - spre[lo];
      row = lo;
      t0 = (rev ? 0 : 1) + B32_DW_PAIRS * j;
      n_in = min(B32_DW_PAIRS, pairs_of(lo) - B32_DW_PAIRS * j);
    };
    // one thread fills dW stage `fill % dw_stages` with stage c: H / HB boxes
    // of hs and one box of dpre, B32_DW_PAIRS frames each (frames past T
    // come in as zeros, frames past the row's pairs are not read)
    auto issue = [&](int c, unsigned fill) {
      const int slot = fill % dw_stages;
      int row, t0, n_in;
      stage_of(c, row, t0, n_in);
      float* st = dws + slot * stage_floats;
      dw_pairs[slot] = n_in;  // published by the arrival below
      mbar_arrive_expect_tx(dw_full_bar(slot), stage_floats * 4);
      for (int hb = 0; hb < n_hb; ++hb)
        tma_load_3d(smem_u32(st + hb * B32_DW_PAIRS * HB), &hmap, dw_full_bar(slot),
                    d * H + hb * HB, rev ? t0 + 1 : t0 - 1, r0 + row);
      b32_tma_load_4d(smem_u32(st + B32_DW_PAIRS * H), &pmap, dw_full_bar(slot), u0, 4 * d, t0,
                      r0 + row);
    };
    // thread item (kt, ct): hidden rows 4 (kt + NKT m) + e, m, e < 4, and own
    // columns 4 ct + e, 2U + 4 ct + e (the order gate * U + unit)
    const int NKT = H / 16, NCT = U / 2, n_items = NKT * NCT;
    float* dw = a.dw + ((long long)rg * a.ndir + d) * H * G;
    unsigned fills = 0;  // dW stages consumed so far: stage and phase of the next
    for (int base = 0; base < n_items; base += nthreads) {
      const int item = base + tid;
      const int kt = item / NCT, ct = item % NCT;
      float acc[16][8];
#pragma unroll
      for (int m = 0; m < 16; ++m)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[m][c] = 0.0f;
      __syncthreads();  // every stage is free: the last pass is done with them
      if (tid == 0)
        for (int c = 0; c < dw_stages && c < n_dw; ++c) issue(c, fills + c);
      for (int c = 0; c < n_dw; ++c, ++fills) {
        const int slot = fills % dw_stages;
        mbar_wait(dw_full_bar(slot), (fills / dw_stages) & 1);
        if (item < n_items) {
          const float* st = dws + slot * stage_floats;
          const int n_in = dw_pairs[slot];
#pragma unroll 1
          for (int k = 0; k < n_in; ++k) {
            float4 hv[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int kq = (kt + NKT * m) * 4;  // in box kq / HB, frame k
              hv[m] = *reinterpret_cast<const float4*>(
                  st + ((kq / HB) * B32_DW_PAIRS + k) * HB + kq % HB);
            }
            const float* pd = st + B32_DW_PAIRS * H + k * 4 * U;
            const float4 d0 = *reinterpret_cast<const float4*>(pd + ct * 4);
            const float4 d1 = *reinterpret_cast<const float4*>(pd + 2 * U + ct * 4);
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float h = comp(hv[m], e);
                const int r = m * 4 + e;
                acc[r][0] = fmaf(h, d0.x, acc[r][0]);
                acc[r][1] = fmaf(h, d0.y, acc[r][1]);
                acc[r][2] = fmaf(h, d0.z, acc[r][2]);
                acc[r][3] = fmaf(h, d0.w, acc[r][3]);
                acc[r][4] = fmaf(h, d1.x, acc[r][4]);
                acc[r][5] = fmaf(h, d1.y, acc[r][5]);
                acc[r][6] = fmaf(h, d1.z, acc[r][6]);
                acc[r][7] = fmaf(h, d1.w, acc[r][7]);
              }
          }
        }
        // the last warp done with the stage refills it with stage c + dw_stages
        __syncwarp();
        if (lane == 0 && release(dw_done_ctr + slot) && c + dw_stages < n_dw) {
          fence_proxy_async();  // the warps' reads of the stage before the copy engine's writes
          issue(c + dw_stages, fills + dw_stages);
        }
      }
      if (item < n_items) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const long long k = (kt + NKT * m) * 4 + e;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int col = (c < 4 ? 0 : 2 * U) + ct * 4 + (c & 3);  // gate * U + unit
              dw[k * G + (col / U) * H + u0 + col % U] = acc[m * 4 + e][c];
            }
          }
      }
    }
    B32_STAMP_DW(1);
  }
}

template <bool WITH_DW>
static cudaError_t launch(BwdArgs a, int grid_dirs, int units, int rows, int stages, int kc,
                          unsigned* sync, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // the exchange as (4H columns, row groups x rows, 2 x grid_dirs); a box is
  // kc columns of up to B32_BOX_ROWS rows of one half and direction
  const cuuint64_t cols = (cuuint64_t)4 * a.H;
  const cuuint64_t rows_pad = (cuuint64_t)((a.B + rows - 1) / rows) * rows;
  CUtensorMap map;
  const cuuint64_t dims[3] = {cols, rows_pad, (cuuint64_t)2 * grid_dirs};
  const cuuint64_t strides[2] = {cols * 4, cols * 4 * rows_pad};
  const cuuint32_t box[3] = {(cuuint32_t)kc,
                             (cuuint32_t)(rows < B32_BOX_ROWS ? rows : B32_BOX_ROWS), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, a.xbuf, dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // WITH_DW: hs as (ndir x H columns, T, B), boxes of H or H / 2 (<= 256) columns x
  // B32_DW_PAIRS frames of one row; dpre as (H, ndir x 4 gates, T, B), boxes
  // of U units x 4 gates x B32_DW_PAIRS frames of one row
  CUtensorMap hmap = map, pmap = map;
  if (WITH_DW) {
    const cuuint64_t nh = (cuuint64_t)a.ndir * a.H, ng = (cuuint64_t)a.ndir * 4 * a.H;
    const cuuint64_t hdims[3] = {nh, (cuuint64_t)a.T, (cuuint64_t)a.B};
    const cuuint64_t hstrides[2] = {nh * 4, nh * 4 * a.T};
    const cuuint32_t hbox[3] = {(cuuint32_t)(a.H / ((a.H + 255) / 256)), B32_DW_PAIRS, 1};
    const cuuint64_t pdims[4] = {(cuuint64_t)a.H, (cuuint64_t)a.ndir * 4, (cuuint64_t)a.T,
                                 (cuuint64_t)a.B};
    const cuuint64_t pstrides[3] = {(cuuint64_t)a.H * 4, ng * 4, ng * 4 * a.T};
    const cuuint32_t pbox[4] = {(cuuint32_t)units, 4, B32_DW_PAIRS, 1};
    const cuuint32_t elem4[4] = {1, 1, 1, 1};
    if (encode(&hmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(a.hs), hdims,
               hstrides, hbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
            CUDA_SUCCESS ||
        encode(&pmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dpre, pdims, pstrides, pbox, elem4,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
            CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  auto kernel = lstm_bwd_kernel<WITH_DW>;
  const size_t smem = b32_smem_bytes(a.H, units, rows, stages, kc, WITH_DW);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  void* params[] = {&a, &map, &hmap, &pmap, &units, &rows, &stages, &kc, &sync};
  const int groups = (a.B + rows - 1) / rows;
  const dim3 grid(grid_dirs * groups * (a.H / units)), block(b32_threads(rows, units));
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid, block, params, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The geometry this body takes (the Python plan checks it first): H a
// multiple of 32 up to 1024 (of 64 above 512), with_dw only up to 512; units
// 8 or 16 dividing H; rows a multiple of B32_RT; rows x units / 4 threads
// (b32_threads) a multiple of 32 up to B32_MAX_THREADS; 2 <= stages <=
// B32_MAX_STAGES; chunks kc of B32_KC or 2 B32_KC columns; WITH_DW at least
// two dW stages.
static bool geometry_ok(int with_dw, int B, int T, int H, int units, int rows, int stages,
                        int kc) {
  const int threads = units > 0 && rows > 0 ? b32_threads(rows, units) : 0;
  return B >= 1 && T >= 1 && H >= 32 && H % 32 == 0 && H <= 1024 && (H <= 512 || H % 64 == 0) &&
         (!with_dw || H <= 512) && (units == 8 || units == 16) && H % units == 0 &&
         rows % B32_RT == 0 && threads % 32 == 0 && threads >= 32 &&
         threads <= B32_MAX_THREADS && stages >= 2 && stages <= B32_MAX_STAGES &&
         (kc == B32_KC || kc == 2 * B32_KC) && 4 * H % kc == 0 &&
         (!with_dw || b32_dw_stages(H, units, rows, stages, kc) >= 2);
}

// One entry for both forms. The tensors hold ndir directions side by side and
// the launch's rows from row 0; the launch runs grid_dirs directions from
// dir0 on (rev_bits over all ndir). `xbuf` the exchange, (2, grid_dirs, row
// groups x rows, 4H) fp32; `sync` grid_dirs x row groups zeroed counters;
// with_dw: `hs` and `dw`, (row groups, ndir, H, 4H) fp32 partial sums. Every
// tensor contiguous float32. Returns a cudaError_t (0 on success).
extern "C" int lstm_bwd_f32_launch(int with_dw, int ndir, int rev_bits, int dir0, int grid_dirs,
                                   int B, int T, int H, const void* gates, const void* cs,
                                   const void* hs, const void* dy, const void* w_hh,
                                   const int* lengths, void* dpre, void* xbuf, float* dw,
                                   int units, int rows, int stages, int kc, void* sync,
                                   void* stream) {
  if (!geometry_ok(with_dw, B, T, H, units, rows, stages, kc)) return (int)cudaErrorInvalidValue;
  BwdArgs a{static_cast<const float*>(gates), static_cast<const float*>(cs),
            static_cast<const float*>(hs),    static_cast<const float*>(dy),
            static_cast<const float*>(w_hh),  lengths,
            static_cast<float*>(dpre),        static_cast<float*>(xbuf),
            dw, ndir, rev_bits, B, T, H, dir0};
  unsigned* ctr = static_cast<unsigned*>(sync);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_dw) return (int)launch<true>(a, grid_dirs, units, rows, stages, kc, ctr, s);
  return (int)launch<false>(a, grid_dirs, units, rows, stages, kc, ctr, s);
}
