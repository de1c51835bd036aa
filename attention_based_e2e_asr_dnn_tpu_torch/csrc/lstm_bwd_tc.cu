// Adjoint of the bfloat16 LSTM recurrence for Hopper (sm_90a), with both
// products on tensor cores (wgmma, bf16 operands from shared memory, fp32
// accumulators) and the exchanged dpre streamed by TMA: one cooperative
// launch walks the whole time loop of one listener layer backwards for up to
// 128 batch rows and every direction. Two forms of one kernel:
//
// Replaces (attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py), in bf16:
//   WITH_DW = false, entry lstm_bwd: _lstm_bwd_kernel (:311), launched by
//       _backward_pallas (:668, the call at :727), the route of layers wider
//       than 512 -- dpre only; dW_hh is one product outside the kernel;
//   WITH_DW = true, entry lstm_bwd_dw: _lstm_bwd_dw_kernel (:382), launched by
//       _backward_pallas_dw (:593, the call at :640), the H <= 512 route,
//       which also sums dW_hh += hs[scan-prev]^T round(dpre).
// float32 runs on lstm_bwd.cu (CUDA-core FMAs, tolerance 1e-4 against the
// plain version, which TF32 tensor cores would not keep). The Pallas
// kernels' k-blocks, boundary term and VMEM routing are the TPU's and are
// not carried over.
//
// What it computes is lstm_bwd.cu's: dh_total, dc_total, the four dpre,
// dh_prev = round(dpre) @ W_hh^T and dc_prev, fp32 sums and carries, a padded
// frame an exact no-op, the scan's first frame paired with h = 0. The dW_hh
// term of step s pairs dpre_{t_last} (the adjoint's previous step, the stage
// that was just multiplied) with hs_t, its scan-previous frame: the first step
// has no t_last and the last step's own dpre pairs with h = 0, which is the
// sliced form of dw_hh_outside.
//
// What bounds it on this card. Every step waits for the previous step's
// dpre from every block of its chain, and every block reads all of its
// chain's rows of it: with one chain a direction, B x 4H bf16 (1 MiB at H =
// 1024, B = 128; 128 blocks then read 128 MiB from L2 a step, 64 MiB at H =
// 512), and the step ran at the L2's rate: 5.4-5.8 TB/s at both widths, 11.9
// us a step of lstm_bwd at H = 512, B = 128, 15.7 us with dW_hh (an H100
// 80GB HBM3 at 700 W, PERF.md). A box of more than 64 rows is 128 rows
// whatever the batch holds, so 96 rows cost what 128 did. The products are
// small (M = 64 rows, N = U = 8 or 16 units, K = 4H; the dW product M = 64
// columns, N = U, K = rows); what is left of a step is the synchronisation of
// each chunk, the chain's counter and the epilogue of U x rows cells.
//
// What the design does about it (lstm_bwd_tc_body.cuh has the layout):
//   * one launch of up to 128 rows and both directions, its rows in row
//     groups of at most 64 (two past 64 rows at H <= 512), each (direction,
//     group) a chain with its own counter that never waits for another chain:
//     a block reads only its group's rows, half the exchange at B = 96 or 128
//     (24 MiB a step at H = 512, B = 96, where it read 48), into a 64-row box;
//     both warpgroups then take one box of each stage, halving each one's
//     chain of wgmma instructions, and share the cell epilogue. At H = 512 the
//     two groups take 16 units a block (2 x 2 x 32 = 128 blocks, W_hh rows 64
//     KB a block), whose dW accumulators (128 fp32 a consumer thread) fit
//     because the producer warpgroup gives its registers to the consumers.
//     On an H100 80GB HBM3 at 700 W (PERF.md), at H = 512, B = 96, T =
//     1536: lstm_bwd_dw 10.4 us a step (15.7 with one chain), lstm_bwd 8.4
//     (11.7). Up to 64 rows and above H = 512 (where 32 units would not fit
//     shared memory) a launch is one group, 8 units a block up to H = 512,
//     16 above (W_hh rows as bf16: 128 KB a block at H = 1024);
//   * the chunk synchronisation: stages of 128 columns (half the chunks of
//     the forward's 64-column ring: 32 a step at H = 1024, 16 at H = 512),
//     filled by TMA from one producer thread and completing on an mbarrier
//     (no cp.async wait, proxy fence or block barrier a chunk); a consumer
//     warp releases a stage through a second mbarrier once its products on it
//     are done, so up to S - 1 stages are in flight behind the one being
//     multiplied;
//   * dW_hh in the same tiles: the stage just multiplied is also the dW
//     product's A operand (read M-major), against hs_t's U columns that the
//     block loads itself (2 KB), in the same commit group; no extra L2 read
//     and nothing between the products and the arrive. Two groups' partials
//     meet in the launch, group 0's plus group 1's, without atomics;
//   * the exchange is a compact double buffer (2, directions, rows, 4H), the
//     forward's hbuf for dpre, written beside the output and read through a
//     3-D tensor map a row group (columns, the group's rows, half x
//     direction). Read from the dpre output itself, a box's rows lie T x ndir
//     x 4H x 2 bytes apart (12 to 25 MB: a page each) and the kernel ran at
//     ~32 KB/us a block at every width; the compact buffer keeps a step's
//     exchange in a few pages (PERF.md has both times). Rows past the
//     group's are filled with zeros by TMA, so the products need no masking.
// Not kept: a cluster of two neighbouring blocks of a direction, each loading
// one box of a stage and multicasting it to both (half the L2 reads a step),
// measured slower on an H100 (PERF.md, PR 8): a stage then waits for both
// blocks' consumers before it is refilled. The row groups halve the reads
// with no such wait.
// The tensor maps are encoded on the host for every launch, through the
// runtime's driver entry point (the library does not link libcuda).

#include "lstm_bwd_tc_body.cuh"

template <bool WITH_DW, int U, bool SPLIT>
static cudaError_t bt_launch(BwdTcArgs a, int grid_dirs, unsigned* sync, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // the exchange (2 x grid_dirs, B, 4H); map g holds row group g's rows of
  // every slab, a box 64 columns of one slab for a chain's rows rounded up to
  // 64 (the rows past the group's read as zeros)
  const cuuint64_t cols = (cuuint64_t)4 * a.H;
  BtMaps maps;
  for (int g = 0; g < BT_MAX_GROUPS; ++g) {
    const int gi = g < a.groups ? g : 0;
    const cuuint64_t dims[3] = {cols, (cuuint64_t)bt_group_rows(a.B, a.groups, gi),
                                (cuuint64_t)2 * grid_dirs};
    const cuuint64_t strides[2] = {cols * 2, cols * 2 * a.B};
    const cuuint32_t box[3] = {64, (cuuint32_t)(SPLIT ? 64 : 128), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    void* base = static_cast<char*>(a.xbuf) + bt_group_row0(a.B, a.groups, gi) * cols * 2;
    if (encode(&maps.m[g], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
        CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  auto kernel = lstm_bwd_tc_kernel<WITH_DW, U, SPLIT>;
  const size_t smem = bt_smem_bytes(bt_group_rows(a.B, a.groups, 0), a.H, U, WITH_DW);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(grid_dirs * a.groups * a.H / U), block(BT_THREADS);
  void* params[] = {&a, &maps, &sync};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid, block, params, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tensors hold ndir directions side by side and the launch's rows from
// row 0; it runs grid_dirs directions from dir0 on (rev_bits over all ndir),
// its rows in `groups` row groups. Shapes (the Python plan checks them
// first): 1 <= B <= 128; H a multiple of 32 up to 512 and of 64 up to 1024;
// units 8 or 16 dividing H; groups 1, or 2 at H <= 512 with B >= 2; with_dw
// only at H <= 512 in chains of at most 64 rows (the plan's: where two groups
// do not fit the SMs, one group of 128 rows and 8 units would not either; hs
// and dw are read only then); `xbuf` the exchange, (2, grid_dirs, B, 4H) bf16;
// `sync` grid_dirs x groups zeroed counters. Returns a cudaError_t (0 on
// success).
extern "C" int lstm_bwd_tc_launch(int with_dw, int ndir, int rev_bits, int dir0, int grid_dirs,
                                  int B, int T, int H, const void* gates, const void* cs,
                                  const void* hs, const void* dy, const void* w_hh,
                                  const int* lengths, void* dpre, void* xbuf, float* dw,
                                  int units, int groups, void* sync, void* stream) {
  const bool groups_ok = groups == 1 || (groups == BT_MAX_GROUPS && B >= 2 && H <= 512);
  const int chain_rows = groups_ok ? bt_group_rows(B, groups, 0) : B;
  const bool split = chain_rows <= BT_GROUP_ROWS;
  const bool shape_ok = B >= 1 && B <= BT_ROWS && T >= 1 && H >= 32 && H % 32 == 0 &&
                        H <= 1024 && (H <= 512 || H % 64 == 0) && (units == 8 || units == 16) &&
                        H % units == 0 && groups_ok &&
                        (!with_dw || (H <= 512 && split)) &&
                        bt_stages(chain_rows, H, units, with_dw) >= 1;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  BwdTcArgs a{gates, cs, hs, dy, w_hh, lengths, dpre, xbuf, dw, ndir, rev_bits, B, T, H, dir0,
              groups};
  unsigned* ctr = static_cast<unsigned*>(sync);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_dw)
    return (int)(units == 8 ? bt_launch<true, 8, true>(a, grid_dirs, ctr, s)
                            : bt_launch<true, 16, true>(a, grid_dirs, ctr, s));
  if (units == 8)
    return (int)(split ? bt_launch<false, 8, true>(a, grid_dirs, ctr, s)
                       : bt_launch<false, 8, false>(a, grid_dirs, ctr, s));
  return (int)(split ? bt_launch<false, 16, true>(a, grid_dirs, ctr, s)
                     : bt_launch<false, 16, false>(a, grid_dirs, ctr, s));
}
