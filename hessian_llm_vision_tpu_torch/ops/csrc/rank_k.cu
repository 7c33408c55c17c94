// Rank-k apply  out = g + V^T (c * (V g))  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair of hessian_llm_vision_tpu/ops/spectral.py:
//   _dots_kernel  (:130, pass 1, sequential grid of 8192-wide P tiles carrying
//                  a (k_pad, 128) VMEM accumulator)  -> rank_k_dots_kernel
//                                                      + rank_k_dots_finalize
//   _axpy_kernel  (:155, pass 2, out[tile] = g[tile] + sum_j c_j V[j, tile])
//                                                    -> rank_k_axpy_kernel
//
// Bound: memory bandwidth.  Each pass does 2 flops per element of V it reads,
// far below the ~20 flops/byte at which an H100 stops being bandwidth-bound,
// so the least time is bytes / 3.35 TB/s.  w depends on every dot product, so
// V is read twice: once per pass.  Pass 1 alone at the LanczosSGD shape
// (k = 10, P = 124,046,592) reads 4.96 GB of f32 V + 0.5 GB of g: 1.629 ms;
// with a bf16 V (2.48 GB) 0.889 ms.
//
// Pass 1 design (rank_k_dots_kernel): one wave of persistent blocks that
// stream P through rings of shared-memory stages filled by bulk copies.
// * The grid is what fits at once (the wrapper asks the occupancy API), so
//   no partly filled second wave of blocks runs at the end.  A fixed 4
//   blocks per SM of a 66-register kernel, where 3 fit, did (PERF.md).
// * Block b takes chunks b, b + grid, b + 2 grid, ... of P: the grid reads
//   one window of each row at a time.  One contiguous span per block
//   (SMs x k far-apart streams) measured slower (PERF.md).
// * Warp 0 is the producer: one thread issues, per chunk, a bulk
//   asynchronous copy (cp.async.bulk, completion counted in bytes on the
//   stage's "full" mbarrier) of g[chunk] and of each row's V[r, chunk].
//   The bytes in flight per SM are the ring's, not bounded by the registers
//   of the threads that wait for loads.
// * Eight consumer warps wait on the full barrier, FMA from shared memory
//   into per-row f32 registers (at most kMaxRows rows per sweep, so k = 35
//   runs three sweeps without spilling), and arrive on the stage's "empty"
//   barrier, which lets the producer refill it.
// * A bulk copy needs 16-byte aligned addresses and sizes.  The wrapper takes
//   this path only when P is a multiple of the 16-byte vector and V and g
//   are 16-byte aligned; chunks are whole vectors, so every copy is aligned
//   and nothing is left over.  Otherwise (V's rows unaligned) it launches
//   rank_k_dots_scalar: a grid-stride loop of 4-byte loads.
// * Per-row sums are reduced through the block with warp shuffles into
//   partials (k, nblocks); rank_k_dots_finalize sums each row in a fixed
//   order and multiplies by c.  No atomics: results repeat bit for bit.
// The grid, chunk, stage and row arithmetic, and the ring's shared-memory
// bytes, are ops/kernels.py::dots_plan's; the launch only checks that the
// ring it is given fits the bytes it is given.
//
// Pass 2 (rank_k_axpy_kernel) is an elementwise grid-stride loop with w in
// shared memory, 16-byte loads where P and the pointers allow, and an f32
// accumulator.  The ragged end of P needs no padding in either pass.  (The
// TPU wrapper padded V, a full copy of V per call.)
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

constexpr int kThreads = 256;  // scalar pass 1, finalize, pass 2
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kRingThreads = 32 + kConsumers;  // warp 0 produces
constexpr int kMaxStages = 8;

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

// The same 16-byte vectors, read from a shared-memory stage.
template <int VEC>
__device__ __forceinline__ void lds_row(const float* p, float (&x)[VEC]) {
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(p)[q];
    x[4 * q + 0] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

template <int VEC>
__device__ __forceinline__ void lds_row(const __nv_bfloat16* p, float (&x)[VEC]) {
  static_assert(VEC == 8, "bf16 rows load 8 elements (16 bytes) at a time");
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    x[2 * q + 0] = f.x;
    x[2 * q + 1] = f.y;
  }
}

// ---- mbarrier and bulk-copy primitives (PTX, sm_90) ------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_u32(bar))
      : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Bulk copy global -> shared; `bytes` and both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Block reduction of per-row sums: eight warps' shuffles, then one thread per
// row adds the eight warp sums in a fixed order into partials[r0 + t, block].
// kNamed: only the consumer warps take part (named barrier 1).
template <bool kNamed>
__device__ __forceinline__ void reduce_sync() {
  if constexpr (kNamed) {
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  } else {
    __syncthreads();
  }
}

template <bool kNamed>
__device__ __forceinline__ void write_partials(float (&acc)[kMaxRows], float (&red)[kWarps][kMaxRows],
                                               int t, int nr, int r0, float* __restrict__ partials) {
  const int lane = t & 31;
  const int warp = t >> 5;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    float s = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][r] = s;
  }
  reduce_sync<kNamed>();
  if (t < nr) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][t];
    partials[static_cast<int64_t>(r0 + t) * gridDim.x + blockIdx.x] = s;
  }
  reduce_sync<kNamed>();
}

static_assert(kConsumerWarps == kWarps, "both pass-1 kernels reduce over eight warps");

// Pass 1: partials[j, b] = sum over block b's chunks of P of V[j, p] * g[p].
// Shared memory: `stages` stages, each g[chunk] (f32) then rows x V[r, chunk].
template <typename T, int VEC>
__global__ void __launch_bounds__(kRingThreads)
rank_k_dots_kernel(const T* __restrict__ V, const float* __restrict__ g,
                   float* __restrict__ partials, int k, int64_t P, int chunk, int stages,
                   int rows) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ float red[kWarps][kMaxRows];

  const int64_t nchunks = (P + chunk - 1) / chunk;  // block b takes chunks b, b + grid, ...
  const size_t g_bytes = static_cast<size_t>(chunk) * sizeof(float);
  const size_t stage_bytes = g_bytes + static_cast<size_t>(rows) * chunk * sizeof(T);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // producer warp: one thread issues every copy
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int r0 = 0; r0 < k; r0 += rows) {
        const int nr = min(rows, k - r0);
        for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
          mbar_wait(&empty[s], phase ^ 1);  // first pass over the ring: free
          const int64_t pos = c * chunk;
          const uint32_t n = static_cast<uint32_t>(P - pos < chunk ? P - pos : chunk);
          unsigned char* st = ring + s * stage_bytes;
          T* vs = reinterpret_cast<T*>(st + g_bytes);
          mbar_arrive_expect_tx(&full[s], n * static_cast<uint32_t>(sizeof(float) + nr * sizeof(T)));
          bulk_load(st, g + pos, n * sizeof(float), &full[s]);
          for (int r = 0; r < nr; ++r) {
            bulk_load(vs + static_cast<size_t>(r) * chunk, V + static_cast<int64_t>(r0 + r) * P + pos,
                      n * sizeof(T), &full[s]);
          }
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int t = threadIdx.x - 32;  // consumer index
  int s = 0;
  uint32_t phase = 0;
  for (int r0 = 0; r0 < k; r0 += rows) {
    const int nr = min(rows, k - r0);
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;

    for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
      mbar_wait(&full[s], phase);
      const int64_t left = P - c * chunk;
      const int n = static_cast<int>(left < chunk ? left : chunk);
      const float* gs = reinterpret_cast<const float*>(ring + s * stage_bytes);
      const T* vs = reinterpret_cast<const T*>(ring + s * stage_bytes + g_bytes);
      for (int e = t * VEC; e < n; e += kConsumers * VEC) {
        float gv[VEC];
        lds_row<VEC>(gs + e, gv);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < nr) {
            float vv[VEC];
            lds_row<VEC>(vs + static_cast<size_t>(r) * chunk + e, vv);
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[r] = fmaf(vv[q], gv[q], acc[r]);
          }
        }
      }
      __syncwarp();
      if ((t & 31) == 0) mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    write_partials<true>(acc, red, t, nr, r0, partials);
  }
}

// Pass 1 where V's rows are not 16-byte aligned: a grid-stride loop of 4-byte
// loads, `rows` rows of V per sweep.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rank_k_dots_scalar(const T* __restrict__ V, const float* __restrict__ g,
                   float* __restrict__ partials, int k, int64_t P, int rows) {
  __shared__ float red[kWarps][kMaxRows];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  for (int r0 = 0; r0 < k; r0 += rows) {
    const int nr = min(rows, k - r0);
    const T* Vr = V + static_cast<int64_t>(r0) * P;
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;

    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < P; i += stride) {
      float gv[1];
      load_f32<1>(g + i, gv);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nr) {
          float vv[1];
          load_row<1>(Vr + static_cast<int64_t>(r) * P + i, vv);
          acc[r] = fmaf(vv[0], gv[0], acc[r]);
        }
      }
    }
    write_partials<false>(acc, red, threadIdx.x, nr, r0, partials);
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
                int64_t P, int nblocks, int bulk, int chunk, int stages, int rows, int smem_bytes,
                cudaStream_t s) {
  if (rows < 1 || rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (bulk) {
    if (stages < 1 || stages > kMaxStages || chunk < VEC || chunk % VEC != 0 ||
        static_cast<int64_t>(stages) * chunk *
                static_cast<int64_t>(sizeof(float) + rows * sizeof(T)) >
            smem_bytes)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        rank_k_dots_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    rank_k_dots_kernel<T, VEC><<<nblocks, kRingThreads, smem_bytes, s>>>(
        static_cast<const T*>(V), static_cast<const float*>(g), static_cast<float*>(partials), k,
        P, chunk, stages, rows);
  } else {
    rank_k_dots_scalar<T><<<nblocks, kThreads, 0, s>>>(
        static_cast<const T*>(V), static_cast<const float*>(g), static_cast<float*>(partials), k,
        P, rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_k_dots_finalize<<<k, kThreads, 0, s>>>(static_cast<const float*>(partials),
                                               static_cast<const float*>(c),
                                               static_cast<float*>(w), nblocks);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the chosen pass-1 kernel that fit on one SM at once.
template <typename T, int VEC>
int dots_blocks_per_sm(int bulk, int smem_bytes, int* blocks) {
  if (!bulk) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, rank_k_dots_scalar<T>, kThreads, 0));
  }
  cudaError_t err = cudaFuncSetAttribute(
      rank_k_dots_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rank_k_dots_kernel<T, VEC>, kRingThreads, smem_bytes));
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

// Pass 1.  bulk != 0: the shared-memory ring of `stages` stages of `chunk`
// elements in `smem_bytes` of dynamic shared memory (P a multiple of 4 (f32)
// / 8 (bf16) elements, V and g 16-byte aligned, checked by the caller); else
// the scalar kernel.  Plan: ops/kernels.py::dots_plan.
int rank_k_dots_f32(const void* V, const void* g, const void* c, void* partials, void* w, int k,
                    long long P, int nblocks, int bulk, int chunk, int stages, int rows,
                    int smem_bytes, void* stream) {
  return launch_dots<float, 4>(V, g, c, partials, w, k, P, nblocks, bulk, chunk, stages, rows,
                               smem_bytes, static_cast<cudaStream_t>(stream));
}

int rank_k_dots_bf16(const void* V, const void* g, const void* c, void* partials, void* w, int k,
                     long long P, int nblocks, int bulk, int chunk, int stages, int rows,
                     int smem_bytes, void* stream) {
  return launch_dots<__nv_bfloat16, 8>(V, g, c, partials, w, k, P, nblocks, bulk, chunk, stages,
                                       rows, smem_bytes, static_cast<cudaStream_t>(stream));
}

int rank_k_dots_blocks_per_sm_f32(int bulk, int smem_bytes, int* blocks) {
  return dots_blocks_per_sm<float, 4>(bulk, smem_bytes, blocks);
}

int rank_k_dots_blocks_per_sm_bf16(int bulk, int smem_bytes, int* blocks) {
  return dots_blocks_per_sm<__nv_bfloat16, 8>(bulk, smem_bytes, blocks);
}

// vectorized != 0: 16-byte loads (P a multiple of 4 (f32) / 8 (bf16) and all
// pointers 16-byte aligned, checked by the caller); else scalar loads.
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
