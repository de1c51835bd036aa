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
// dpre from every block of its direction, and every block reads ALL of it:
// B x 4H bf16, 1 MiB at H = 1024, B = 128, so 128 blocks read 128 MiB from L2
// a step (64 MiB at H = 512), four times the forward's exchange; at the L2's
// few TB/s that alone is ~10-25 us of a step. The products are small (M = 64
// rows, N = U = 8 or 16 units, K = 4H; the dW product M = 64 columns, N = U,
// K = rows), so a step is the exchange's L2 traffic, the synchronisation of
// each chunk of it, the per-direction barrier and the epilogue of U x B cells.
// The float32 body (lstm_bwd.cu) did a launch per 32 rows (and per direction
// at H = 1024: 8 serial launches a call at B = 128), fp32 FMAs on CUDA cores, a
// grid-wide barrier a step and the dW_hh update on the critical path.
//
// What the design does about it (lstm_bwd_tc_body.cuh has the layout):
//   * one launch of 128 rows and both directions (W_hh rows as bf16: 128 KB a
//     block of 16 units at H = 1024, 32 KB of 8 at H = 512), one dependent
//     chain of T steps a layer, a counter per direction instead of a grid
//     barrier;
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
//     and nothing between the products and the arrive;
//   * the exchange is a compact double buffer (2, directions, rows, 4H), the
//     forward's hbuf for dpre, written beside the output and read through a
//     3-D tensor map (columns, rows, half x direction). Read from the dpre
//     output itself, a box's 128 rows lie T x ndir x 4H x 2 bytes apart (12
//     to 25 MB: a page each) and the kernel ran at ~32 KB/us a block at every
//     width; the compact buffer keeps a step's exchange in a few pages
//     (PERF.md, PR 8, has both times). Rows past B are filled with zeros by
//     TMA, so the products need no masking.
// Not kept: a cluster of two neighbouring blocks of a direction, each loading
// one box of a stage and multicasting it to both (half the L2 reads a step),
// measured slower on an H100 (PERF.md, PR 8): a stage then waits for both
// blocks' consumers before it is refilled.
// The tensor map is encoded on the host for every launch, through the
// runtime's driver entry point (the library does not link libcuda).

#include "lstm_bwd_tc_body.cuh"

template <bool WITH_DW, int U>
static cudaError_t bt_launch(BwdTcArgs a, int grid_dirs, unsigned* sync, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // the exchange (2 x grid_dirs, B, 4H); a box is 64 columns of one half and
  // direction for the launch's rows rounded up to 64
  const cuuint64_t cols = (cuuint64_t)4 * a.H;
  CUtensorMap map;
  const cuuint64_t dims[3] = {cols, (cuuint64_t)a.B, (cuuint64_t)2 * grid_dirs};
  const cuuint64_t strides[2] = {cols * 2, cols * 2 * a.B};
  const cuuint32_t box[3] = {64, (cuuint32_t)bt_box_rows(a.B), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.xbuf, dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = lstm_bwd_tc_kernel<WITH_DW, U>;
  const size_t smem = bt_smem_bytes(a.B, a.H, U, WITH_DW);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(grid_dirs * a.H / U), block(BT_THREADS);
  void* params[] = {&a, &map, &sync};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid, block, params, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tensors hold ndir directions side by side and the launch's rows from
// row 0; it runs grid_dirs directions from dir0 on (rev_bits over all ndir).
// Shapes (the Python plan checks them first): 1 <= B <= 128; H a multiple of
// 32 up to 512 and of 64 up to 1024; units 8 or 16 dividing H; with_dw only
// with 8 units and H <= 512 (hs and dw are read only then); `xbuf` the
// exchange, (2, grid_dirs, B, 4H) bf16; `sync` grid_dirs zeroed counters.
// Returns a cudaError_t (0 on success).
extern "C" int lstm_bwd_tc_launch(int with_dw, int ndir, int rev_bits, int dir0, int grid_dirs,
                                  int B, int T, int H, const void* gates, const void* cs,
                                  const void* hs, const void* dy, const void* w_hh,
                                  const int* lengths, void* dpre, void* xbuf, float* dw,
                                  int units, void* sync, void* stream) {
  const bool shape_ok = B >= 1 && B <= BT_ROWS && T >= 1 && H >= 32 && H % 32 == 0 &&
                        H <= 1024 && (H <= 512 || H % 64 == 0) && (units == 8 || units == 16) &&
                        H % units == 0 && (!with_dw || (units == 8 && H <= 512)) &&
                        bt_stages(B, H, units, with_dw) >= 1;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  BwdTcArgs a{gates, cs, hs, dy, w_hh, lengths, dpre, xbuf, dw, ndir, rev_bits, B, T, H, dir0};
  unsigned* ctr = static_cast<unsigned*>(sync);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_dw) return (int)bt_launch<true, 8>(a, grid_dirs, ctr, s);
  if (units == 8) return (int)bt_launch<false, 8>(a, grid_dirs, ctr, s);
  return (int)bt_launch<false, 16>(a, grid_dirs, ctr, s);
}
