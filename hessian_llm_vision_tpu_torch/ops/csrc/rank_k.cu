// Rank-k apply  out = g + V^T (c * (V g))  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair of hessian_llm_vision_tpu/ops/spectral.py:
//   _dots_kernel  (pass 1, sequential grid of 8192-wide P tiles carrying a
//                  (k_pad, 128) VMEM accumulator)  -> rank_k_dots_kernel
//                                                     + rank_k_dots_finalize
//   _axpy_kernel  (pass 2, out[tile] = g[tile] + sum_j c_j V[j, tile])
//                                                  -> rank_k_axpy_kernel
//
// Bound: memory bandwidth.  Each pass does 2 flops per element of V it reads,
// far below the ~20 flops/byte at which an H100 stops being bandwidth-bound,
// so the least time is bytes / 3.35 TB/s.  w depends on every dot product, so
// V is read twice: once per pass.  At the LanczosSGD main path (k = 10,
// P = 124,046,592, bf16 V) that is 2 x 2.48 GB of V plus 1.5 GB of g and out.
//
// Design:
// * Blocks run in parallel and in no order, so nothing carries between them
//   as the TPU grid's VMEM scratch did.  Pass 1 runs a few blocks per SM, each
//   a grid-stride loop over P with 16-byte loads of V and g; per-row partial
//   sums stay in registers (at most kMaxRows rows per sweep, so k = 35 runs
//   three sweeps without spilling), are reduced through the block with warp
//   shuffles, and are written as partials (k, nblocks).  A second small kernel
//   sums each row of partials in a fixed order and multiplies by c.  No
//   atomics: results repeat bit for bit from run to run.
// * Pass 2 is an elementwise grid-stride loop with w in shared memory and an
//   f32 accumulator.
// * The ragged end of P needs no padding: the grid-stride bound is the mask.
//   (The TPU wrapper padded V, a full copy of V per call.)  The 16-byte path
//   requires P to be a multiple of the vector width and 16-byte aligned
//   pointers; the wrapper otherwise selects the scalar path (VEC = 1).
// * Offsets into V are 64-bit: k * P exceeds 2^31 at k = 35, P = 124M.
// * The bf16 kernels read bf16 V but keep g and w in f32, so they are MORE
//   exact than the plain rank_k_apply_bf16, which also rounds g and w to bf16.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;

// VEC consecutive f32 values of g (VEC = 1, 4 or 8).
template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = __ldg(p);
  } else {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
      x[4 * q + 0] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* __restrict__ p, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = x[0];
  } else {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(x[4 * q + 0], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
  }
}

// VEC consecutive elements of a row of V, widened to f32: one 16-byte load.
template <int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&x)[VEC]) {
  load_f32<VEC>(p, x);
}

template <int VEC>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = __bfloat162float(p[0]);
  } else {
    static_assert(VEC == 8, "bf16 rows load 8 elements (16 bytes) at a time");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      x[2 * q + 0] = f.x;
      x[2 * q + 1] = f.y;
    }
  }
}

// Pass 1: partials[j, b] = sum over block b's share of P of V[j, p] * g[p].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rank_k_dots_kernel(const T* __restrict__ V, const float* __restrict__ g,
                   float* __restrict__ partials, int k, int64_t P) {
  __shared__ float red[kWarps][kMaxRows];
  const int64_t nvec = P / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int r0 = 0; r0 < k; r0 += kMaxRows) {
    const int nr = min(kMaxRows, k - r0);
    const T* Vr = V + static_cast<int64_t>(r0) * P;
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;

    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < nvec;
         i += stride) {
      float gv[VEC];
      load_f32<VEC>(g + i * VEC, gv);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr) {
          float vv[VEC];
          load_row<VEC>(Vr + static_cast<int64_t>(r) * P + i * VEC, vv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r] = fmaf(vv[e], gv[e], acc[r]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      float s = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp][r] = s;
    }
    __syncthreads();
    const int t = static_cast<int>(threadIdx.x);
    if (t < nr) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][t];
      partials[static_cast<int64_t>(r0 + t) * gridDim.x + blockIdx.x] = s;
    }
    __syncthreads();
  }
}

// Pass 1, second stage: w[j] = c[j] * sum_b partials[j, b], one block per row,
// summed in a fixed order (deterministic).
__global__ void __launch_bounds__(kThreads)
rank_k_dots_finalize(const float* __restrict__ partials, const float* __restrict__ c,
                     float* __restrict__ w, int nblocks) {
  __shared__ float red[kThreads];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += kThreads)
    s += partials[static_cast<int64_t>(j) * nblocks + b];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) w[j] = c[j] * red[0];
}

// Pass 2: out[p] = g[p] + sum_j w[j] * V[j, p].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rank_k_axpy_kernel(const T* __restrict__ V, const float* __restrict__ g,
                   const float* __restrict__ w, float* __restrict__ out, int k, int64_t P) {
  extern __shared__ float ws[];
  for (int j = threadIdx.x; j < k; j += kThreads) ws[j] = w[j];
  __syncthreads();
  const int64_t nvec = P / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < nvec;
       i += stride) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      float vv[VEC];
      load_row<VEC>(V + static_cast<int64_t>(j) * P + i * VEC, vv);
      const float wj = ws[j];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wj, vv[e], acc[e]);
    }
    float gv[VEC];
    load_f32<VEC>(g + i * VEC, gv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = gv[e] + acc[e];
    store_f32<VEC>(out + i * VEC, acc);
  }
}

template <typename T, int VEC>
int launch_dots(const void* V, const void* g, const void* c, void* partials, void* w, int k,
                int64_t P, int nblocks, cudaStream_t s) {
  rank_k_dots_kernel<T, VEC><<<nblocks, kThreads, 0, s>>>(
      static_cast<const T*>(V), static_cast<const float*>(g), static_cast<float*>(partials), k,
      P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_k_dots_finalize<<<k, kThreads, 0, s>>>(static_cast<const float*>(partials),
                                               static_cast<const float*>(c),
                                               static_cast<float*>(w), nblocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_axpy(const void* V, const void* g, const void* w, void* out, int k, int64_t P,
                int nblocks, cudaStream_t s) {
  rank_k_axpy_kernel<T, VEC><<<nblocks, kThreads, k * sizeof(float), s>>>(
      static_cast<const T*>(V), static_cast<const float*>(g), static_cast<const float*>(w),
      static_cast<float*>(out), k, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vectorized != 0: 16-byte loads (P a multiple of 4 (f32) / 8 (bf16) and all
// pointers 16-byte aligned, checked by the caller); else scalar loads.
int rank_k_dots_f32(const void* V, const void* g, const void* c, void* partials, void* w, int k,
                    long long P, int nblocks, int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vectorized ? launch_dots<float, 4>(V, g, c, partials, w, k, P, nblocks, s)
                    : launch_dots<float, 1>(V, g, c, partials, w, k, P, nblocks, s);
}

int rank_k_dots_bf16(const void* V, const void* g, const void* c, void* partials, void* w, int k,
                     long long P, int nblocks, int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vectorized ? launch_dots<__nv_bfloat16, 8>(V, g, c, partials, w, k, P, nblocks, s)
                    : launch_dots<__nv_bfloat16, 1>(V, g, c, partials, w, k, P, nblocks, s);
}

int rank_k_axpy_f32(const void* V, const void* g, const void* w, void* out, int k, long long P,
                    int nblocks, int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vectorized ? launch_axpy<float, 4>(V, g, w, out, k, P, nblocks, s)
                    : launch_axpy<float, 1>(V, g, w, out, k, P, nblocks, s);
}

int rank_k_axpy_bf16(const void* V, const void* g, const void* w, void* out, int k, long long P,
                     int nblocks, int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vectorized ? launch_axpy<__nv_bfloat16, 8>(V, g, w, out, k, P, nblocks, s)
                    : launch_axpy<__nv_bfloat16, 1>(V, g, w, out, k, P, nblocks, s);
}

}  // extern "C"
