// Additive (Bahdanau) attention scores of one decode step, and their adjoint,
// for Hopper (sm_90a), in bfloat16 or float32.
//
//   scores[b, h, t] = sum_d v[h, d] * tanh(q[b, h, d] + k[b, t, h, d])
//
// where frame t of row b is valid (mask[b, t] == 0), and `neg` (the dtype's
// most negative finite value, as the dot-product score is masked) where it
// is padded. The adjoint, given ds[b, h, t]:
//
//   dpre[b, t, h, d] = ds[b, h, t] * v[h, d] * (1 - tanh^2)   (0 where padded)
//   dk = dpre,   dq[b, h, d] = sum_t dpre,   dv[h, d] = sum_{b, t} ds * tanh
//
// Replaces no TPU kernel: the JAX package scores attention by dot products
// only. It was added for the additive score of Chiu et al. 2018's LAS
// (configs/chiu-las.yml), whose speller runs the step loop
// (models/las.py::speller_apply): done in plain ops, autograd would keep a
// (B, Te, heads x d_head) tanh for every decode step; the adjoint here
// recomputes it from q and k, which it reads anyway.
//
// What bounds it. Per step the forward reads k once at the valid frames (at
// the chiu-las cell, B = 128, Te = 512, 4 x 256: up to 134 MB in bfloat16,
// ~40 us at 3.35 TB/s) and does one tanh and two FMAs an element; the
// adjoint reads k again and writes dk whole (~80 us). Both are bound by
// memory; the tanh of the bfloat16 form is the one-instruction
// `tanh.approx.f32`, so the special-function unit (~18 us a pass of 67M
// elements) stays under the bytes. The float32 form takes tanhf.
//
// Design. The row (b, h, t) of k is d_head contiguous elements. A warp takes
// a row at a time: lane l holds elements [8 c, 8 c + 8) for the chunks c = l
// + 32 j (j < NJ, d_head <= 256 NJ), loaded 16 bytes at a time in bfloat16,
// with q[b, h] and v[h] of those elements in registers for the whole block.
// The row's sum is a warp shuffle reduction, in fp32. Each warp keeps RPW
// rows' loads in flight before it computes (128 bytes a lane: 8 rows at
// d_head 256 in bfloat16). Forward: block (tile, b * heads + h) scores RPW x
// 8 warps frames of one (b, h); padded frames load nothing. Adjoint: block b * heads + h walks every frame of (b, h) so that
// dq is summed inside the block (warps' partial sums through shared memory,
// no atomics: the result does not depend on the order blocks run in); dv's
// sum over b leaves the block as a float32 partial a (b, h), summed over b
// by the caller (ops/speller_additive.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SA_WARPS 8
#define SA_THREADS (SA_WARPS * 32)

namespace {

// rows a warp keeps in flight: 128 bytes of k a lane
template <typename T, int NJ>
constexpr int rows_in_flight() {
  return 128 / (8 * (int)sizeof(T) * NJ) > 0 ? 128 / (8 * (int)sizeof(T) * NJ) : 1;
}

__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 8 consecutive elements of a row: one 16-byte load in bfloat16, two in
// float32
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_float(float* f) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ __forceinline__ void from_float(const float* f) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = raw;
  }
  static __device__ __forceinline__ float act(float x) { return tanh_fast(x); }
};

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void to_float(float* f) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ __forceinline__ void from_float(const float* f) {
    a = make_float4(f[0], f[1], f[2], f[3]);
    b = make_float4(f[4], f[5], f[6], f[7]);
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<float4*>(p)[0] = a;
    reinterpret_cast<float4*>(p)[1] = b;
  }
  static __device__ __forceinline__ float act(float x) { return tanhf(x); }
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q[b, h] and v[h] of the lane's chunks, as float
template <typename T, int NJ>
__device__ __forceinline__ void load_qv(const T* q, const T* v, int chunks, int lane,
                                        float (&qf)[NJ][8], float (&vf)[NJ][8]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    Vec8<T> a, b;
    if (c < chunks) {
      a.load(q + 8 * c);
      b.load(v + 8 * c);
    } else {
      a.zero();
      b.zero();
    }
    a.to_float(qf[j]);
    b.to_float(vf[j]);
  }
}

// grid (ceil(Te / (RPW * SA_WARPS)), B * H), SA_THREADS threads
template <typename T, int NJ, int RPW>
__global__ void __launch_bounds__(SA_THREADS)
speller_additive_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const uint8_t* __restrict__ mask,
                               T* __restrict__ scores, int Te, int H, int D, float neg) {
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = D >> 3;
  float qf[NJ][8], vf[NJ][8];
  load_qv<T, NJ>(q + (size_t)bh * D, v + (size_t)h * D, chunks, lane, qf, vf);
  const int t0 = blockIdx.x * RPW * SA_WARPS + warp;
  Vec8<T> kr[RPW][NJ];
  bool live[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int t = t0 + r * SA_WARPS;
    live[r] = t < Te && !mask[(size_t)b * Te + t];
    const T* row = k + (((size_t)b * Te + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (live[r] && c < chunks) kr[r][j].load(row + 8 * c);
      else kr[r][j].zero();
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int t = t0 + r * SA_WARPS;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float kf[8];
      kr[r][j].to_float(kf);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(vf[j][e], Vec8<T>::act(qf[j][e] + kf[e]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0 && t < Te) scores[(size_t)bh * Te + t] = from_f<T>(live[r] ? acc : neg);
  }
}

// grid (B * H), SA_THREADS threads, dynamic shared memory SA_WARPS * D floats
template <typename T, int NJ, int RPW>
__global__ void __launch_bounds__(SA_THREADS)
speller_additive_scores_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const uint8_t* __restrict__ mask,
                                   const T* __restrict__ ds, T* __restrict__ dq,
                                   T* __restrict__ dk, float* __restrict__ dv_part, int Te,
                                   int H, int D) {
  extern __shared__ float red[];  // [SA_WARPS][D]
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = D >> 3;
  float qf[NJ][8], vf[NJ][8];
  load_qv<T, NJ>(q + (size_t)bh * D, v + (size_t)h * D, chunks, lane, qf, vf);
  float dqa[NJ][8], dva[NJ][8];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) dqa[j][e] = dva[j][e] = 0.f;

  for (int t0 = warp; t0 < Te; t0 += RPW * SA_WARPS) {
    Vec8<T> kr[RPW][NJ];
    float g[RPW];
    bool live[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int t = t0 + r * SA_WARPS;
      live[r] = t < Te && !mask[(size_t)b * Te + t];
      g[r] = live[r] ? to_f<T>(ds[(size_t)bh * Te + t]) : 0.f;
      const T* row = k + (((size_t)b * Te + t) * H + h) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (live[r] && c < chunks) kr[r][j].load(row + 8 * c);
        else kr[r][j].zero();
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int t = t0 + r * SA_WARPS;
      if (t >= Te) continue;
      T* out = dk + (((size_t)b * Te + t) * H + h) * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (c >= chunks) continue;
        float kf[8], d[8];
        kr[r][j].to_float(kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float th = Vec8<T>::act(qf[j][e] + kf[e]);
          d[e] = live[r] ? g[r] * vf[j][e] * (1.f - th * th) : 0.f;
          dqa[j][e] += d[e];
          dva[j][e] = fmaf(g[r], th, dva[j][e]);
        }
        Vec8<T> o;
        o.from_float(d);
        o.store(out + 8 * c);
      }
    }
  }

  // the warps' partial sums: dq of (b, h), then dv's partial of (b, h)
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < chunks)
#pragma unroll
        for (int e = 0; e < 8; ++e) red[warp * D + 8 * c + e] = pass ? dva[j][e] : dqa[j][e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < D; i += SA_THREADS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < SA_WARPS; ++w) s += red[w * D + i];
      if (pass) dv_part[(size_t)bh * D + i] = s;
      else dq[(size_t)bh * D + i] = from_f<T>(s);
    }
    __syncthreads();
  }
}

template <typename T, int NJ>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                       void* scores, int B, int H, int Te, int D, float neg, cudaStream_t s) {
  constexpr int rpw = rows_in_flight<T, NJ>();
  dim3 grid((Te + rpw * SA_WARPS - 1) / (rpw * SA_WARPS), B * H);
  speller_additive_scores_kernel<T, NJ, rpw><<<grid, SA_THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(scores), Te, H, D, neg);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                       const void* ds, void* dq, void* dk, float* dv_part, int B, int H, int Te,
                       int D, cudaStream_t s) {
  const size_t smem = sizeof(float) * SA_WARPS * D;
  speller_additive_scores_bwd_kernel<T, NJ, rows_in_flight<T, NJ>()><<<B * H, SA_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<const T*>(ds), static_cast<T*>(dq), static_cast<T*>(dk), dv_part, Te, H, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, H, D), k (B, Te, H, D), v (H, D)
// and scores (B, H, Te) in that dtype, mask (B, Te) bytes (non-zero:
// padded), all contiguous; D a multiple of 8 up to 1024. Returns a
// cudaError_t (0 on success).
extern "C" int speller_additive_scores_launch(int dtype, const void* q, const void* k,
                                              const void* v, const void* mask, void* scores,
                                              int B, int H, int Te, int D, float neg,
                                              void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nj = (D + 255) / 256;
  if (D % 8 != 0 || nj > 4) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 1) {
    err = nj == 1   ? launch_fwd<__nv_bfloat16, 1>(q, k, v, m, scores, B, H, Te, D, neg, s)
          : nj == 2 ? launch_fwd<__nv_bfloat16, 2>(q, k, v, m, scores, B, H, Te, D, neg, s)
                    : launch_fwd<__nv_bfloat16, 4>(q, k, v, m, scores, B, H, Te, D, neg, s);
  } else {
    err = nj == 1   ? launch_fwd<float, 1>(q, k, v, m, scores, B, H, Te, D, neg, s)
          : nj == 2 ? launch_fwd<float, 2>(q, k, v, m, scores, B, H, Te, D, neg, s)
                    : launch_fwd<float, 4>(q, k, v, m, scores, B, H, Te, D, neg, s);
  }
  return (int)err;
}

// the adjoint: q, k, v, mask as the forward takes them, ds (B, H, Te); writes
// dq (B, H, D) and dk (B, Te, H, D) in the dtype (dk zero at padded frames)
// and dv_part (B, H, D) float32, dv's partial sum of each row b.
extern "C" int speller_additive_scores_bwd_launch(int dtype, const void* q, const void* k,
                                                  const void* v, const void* mask,
                                                  const void* ds, void* dq, void* dk,
                                                  void* dv_part, int B, int H, int Te, int D,
                                                  void* stream) {
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* dvp = static_cast<float*>(dv_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nj = (D + 255) / 256;
  if (D % 8 != 0 || nj > 4) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 1) {
    err = nj == 1   ? launch_bwd<__nv_bfloat16, 1>(q, k, v, m, ds, dq, dk, dvp, B, H, Te, D, s)
          : nj == 2 ? launch_bwd<__nv_bfloat16, 2>(q, k, v, m, ds, dq, dk, dvp, B, H, Te, D, s)
                    : launch_bwd<__nv_bfloat16, 4>(q, k, v, m, ds, dq, dk, dvp, B, H, Te, D, s);
  } else {
    err = nj == 1   ? launch_bwd<float, 1>(q, k, v, m, ds, dq, dk, dvp, B, H, Te, D, s)
          : nj == 2 ? launch_bwd<float, 2>(q, k, v, m, ds, dq, dk, dvp, B, H, Te, D, s)
                    : launch_bwd<float, 4>(q, k, v, m, ds, dq, dk, dvp, B, H, Te, D, s);
  }
  return (int)err;
}
