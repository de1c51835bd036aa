// Hopper (sm_90a) building blocks shared by the tensor-core bodies
// (lstm_scan_tc_body.cuh, the LSTM forward; lstm_bwd_tc_body.cuh, its
// adjoint; speller_decode_tc.cu, the fused decode): wgmma on
// 128-byte-swizzled bf16 tiles in shared memory, the async-proxy fences,
// mbarriers, TMA tile loads and the host's tensor-map encoder, and the
// counters a persistent grid synchronises on.
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime)
#include <cuda_bf16.h>
#include <stdint.h>

constexpr int TC_SMEM_LIMIT = 232448;  // shared memory a block may use (sm_90)
constexpr int TC_ALIGN = 1024;         // the swizzled tiles' alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte piece `c` (0..7) of row `r` in a [rows][64] bf16 tile
// (wgmma's and TMA's 128-byte swizzle, tile on a 1024-byte boundary)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma: a warpgroup's 64 x N x 16 product, A and B from shared memory
// through descriptors, fp32 accumulators in registers (N / 2 a thread),
// always accumulating into d. TRANS_A = 1 reads A M-major (the tile's
// contiguous dimension is M, not K), which bf16 allows.
template <int N, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b) {
  static_assert(N == 8 || N == 16 || N == 24 || N == 32 || N == 64,
                "n8, n16, n24, n32 or n64");
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1), "n"(TRANS_A));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1), "n"(TRANS_A));
  } else if constexpr (N == 24) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
        "}, %12, %13, p, 1, 1, %15, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(a), "l"(b), "r"(1), "n"(TRANS_A));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1), "n"(TRANS_A));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TRANS_A));
  }
}

// a compile-time count of columns, handed to a generic lambda
template <int V>
struct Cols {
  static constexpr int value = V;
};

// the descriptor of a bf16 tile of 128-byte rows, 16-byte pieces
// XOR-swizzled by the row's low three bits (the 128-byte swizzle), rows in
// groups of eight 1024 bytes apart; `saddr` 1024-byte aligned but for the
// k offset within a row. The same descriptor reads such a tile K-major (rows
// along M or N, 64 k a row) or, under TRANS_A, M-major (rows along k, 64
// values of M a row: a wgmma of M = 64 takes one row's width).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// keep the compiler from touching accumulators while products are in flight
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// wait until at most P of this warpgroup's product groups are in flight; the
// accumulators are its operands, so that nothing reads them before
template <int P, int R>
__device__ __forceinline__ void wgmma_wait(float (&d)[R]) {
  static_assert(R == 4 || R == 8 || R == 12 || R == 16 || R == 32, "n8 .. n64 accumulators");
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(P) : "memory");
  fence_operands(d);
}
// shared-memory writes of the generic proxy (st.shared, cp.async) before
// wgmma or TMA (the async proxy) reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// global-memory writes of the generic proxy before TMA reads them, and a
// generic acquire before TMA loads that depend on it
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void arrive_release(unsigned* ctr) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ctr) : "memory");
}
__device__ __forceinline__ unsigned load_acquire(const unsigned* ctr) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(ctr) : "memory");
  return v;
}

// mbarriers in shared memory (addresses from smem_u32)
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// TMA: one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* tmap, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// the registers each thread of the calling warpgroup holds from here on
// (setmaxnreg, every warp of the warpgroup): a producer gives them up so that
// the consumers can take them; a multiple of 8 from 24 to 256
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// a named barrier over `threads` threads (id 0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// V = 1, 2, 4 or 8 adjacent bf16 values as one access of 2 V bytes (aligned)
template <int V>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* f) {
  static_assert(V == 1 || V == 2 || V == 4 || V == 8, "1, 2, 4 or 8 values");
  if constexpr (V == 1) {
    f[0] = __bfloat162float(*p);
  } else {
    uint32_t w[V / 2];
    if constexpr (V == 2) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (V == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    }
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = v.x, f[2 * i + 1] = v.y;
    }
  }
}
template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float* f) {
  static_assert(V == 1 || V == 2 || V == 4 || V == 8, "1, 2, 4 or 8 values");
  if constexpr (V == 1) {
    *p = __float2bfloat16(f[0]);
  } else {
    uint32_t w[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    if constexpr (V == 2) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// R adjacent values of which the first n are read (the rest 0) or written:
// one access of 2 R bytes where `vec` (n == R, R 1, 2 or 4, the address
// aligned to 2 R bytes), else one value at a time
template <int R>
__device__ __forceinline__ void load_units(const __nv_bfloat16* p, int n, bool vec, float* f) {
  if constexpr (R == 1 || R == 2 || R == 4) {
    if (vec) {
      load_bf16<R>(p, f);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) f[i] = i < n ? __bfloat162float(p[i]) : 0.0f;
}
template <int R>
__device__ __forceinline__ void store_units(__nv_bfloat16* p, int n, bool vec, const float* f) {
  if constexpr (R == 1 || R == 2 || R == 4) {
    if (vec) {
      store_bf16<R>(p, f);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i < n) p[i] = __float2bfloat16(f[i]);
}

// cuTensorMapEncodeTiled, through the runtime's driver entry point (the
// libraries do not link libcuda); null where the driver lacks it
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}
