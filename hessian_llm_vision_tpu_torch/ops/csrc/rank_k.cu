// Rank-k apply  out = g + V^T (c * (V g))  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair of hessian_llm_vision_tpu/ops/spectral.py:
//   _dots_kernel  (:130, pass 1, sequential grid of 8192-wide P tiles carrying
//                  a (k_pad, 128) VMEM accumulator)  -> rank_k_dots_kernel
//   _axpy_kernel  (:155, pass 2, out[tile] = g[tile] + sum_j c_j V[j, tile])
//                                                    -> rank_k_axpy_ring
//                                                     / rank_k_axpy_direct
//
// Bound: memory bandwidth.  Each pass does 2 flops per element of V it reads,
// far below the ~20 flops/byte at which an H100 stops being bandwidth-bound,
// so the least time is bytes / 3.35 TB/s.  w depends on every dot product, so
// V is read twice: once per pass.  Pass 1 alone at the LanczosSGD shape
// (k = 10, P = 124,046,592) reads 4.96 GB of f32 V + 0.5 GB of g: 1.629 ms;
// with a bf16 V (2.48 GB) 0.889 ms.
//
// Pass 1 design (rank_k_dots_kernel, one kernel for every k, P and
// alignment): one wave of persistent blocks that stream P through rings of
// shared-memory stages filled by bulk copies.  Its bound at any alignment
// is (k P es + 4 P) bytes / 3.35 TB/s: the ends that the producer warp
// loads are bytes of V and g like the rest, each read once.
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
// * Alignment.  A bulk copy needs 16-byte aligned addresses and sizes and
//   keeps an address's offset within its 16 bytes, so it cannot move a row
//   that starts off 16 bytes (VGG-16's and ResNet-50's P = 2 mod 8 at 10
//   classes: every row after the first; the forget CLI's P = 5 mod 8; g as
//   a slice of a flat gradient; V's base as a view).  The template flag
//   kShift takes these.  A chunk is whole 128-byte lines of g and of each
//   row, so each operand sits at one offset within 128 bytes in every
//   chunk.  Its slot in a stage is 128-byte aligned with 128 bytes of slack
//   and holds element e at that offset plus e * es (slot_offset), so each
//   bulk copy's destination lies against 128-byte lines as its source does
//   (slots 16-byte aligned, which moved copies off their source's lines,
//   ran 2-5% slower at the unaligned rows: PERF.md).  The producer thread
//   bulk-copies the 16-byte aligned interior of each operand's chunk; then
//   the warp's other 31 lanes load the fewer than 16 bytes at each end from
//   global memory into the slot and arrive on the full barrier too.  No byte outside V's k
//   rows or g's P elements is read.  The consumers read a group of a row at
//   its shift (its address mod 16): one 16-byte load where the shift is 0,
//   8-byte (f32), 4-byte or, at an odd bf16 shift, 2-byte loads otherwise;
//   the last, partial group of P element by element.  The shifts move no
//   product from one run of a sum to another, and the shifted ring's grid
//   depends on k, P and the dtype alone, so its w has the same bits at
//   every alignment of the same data.  Where V's rows and g are aligned and
//   P is whole vectors (the plan's `aligned`), kShift is false: the stages
//   carry no slack, one thread produces, the consumers load 16 bytes at a
//   time (0.1-1.2% faster than the shifted ring forced onto the same
//   inputs, 4-6% at the MLP leaf: PERF.md).
//   The two replaced a grid-stride kernel of one 2- or 4-byte load per row
//   per thread for unaligned rows, which reached 49% of the bound in bf16
//   and lost to torch.mv (PERF.md).
// * A thread sums its products in f32 only over a short run (one pass over
//   the ring).  Then its warp adds the 32 runs (a shuffle tree) into one
//   double per row in shared memory and the thread starts again from 0.
//   Before, a thread summed its whole share of P in f32 (10,464 products at
//   Pythia-1.4B's (4, 1.41e9)), and that sum's rounding, which grows with P,
//   put w 2.3x farther from a float64 w than cuBLAS's (PERF.md).
// * The block's eight warp sums go, added in double, into partials (k,
//   nblocks) in f32.  The last block to finish (a count in the wrapper's
//   scratch, which that block resets to 0) sums each row of partials in a
//   fixed order, in double, one warp a row, and multiplies by c.  No atomic touches a sum:
//   results repeat bit for bit.  Folding this into pass 1 saves a second
//   launch at every call; the kernel's shared-memory limit is raised once
//   per device (allow_smem), not at every call.
// The grid, chunk, stage and row arithmetic, and the ring's shared-memory
// bytes, are ops/kernels.py::dots_plan's; the launch only checks that the
// ring it is given fits the bytes it is given and, for an aligned plan, that
// the operands are aligned.
//
// Pass 2 design.  out = g + V^T w reads k*P*es bytes of V and 4P of g and
// writes 4P of out; 2k flops per element leave it bound by bytes, so the
// design's one job is to keep enough bytes in flight on every SM at every
// shape the paths launch ((10, 124M) down to a (4, 2.36M) leaf of the
// layer-wise trainer, and up to k = 12288 rows in ef_apply).
// * rank_k_axpy_ring, for large P: one wave of persistent blocks (grid from
//   the occupancy API), each streaming chunks b, b + grid, ... of P through a
//   ring of shared-memory stages filled by bulk copies, like pass 1.  A stage
//   holds g[chunk] and `rows` rows of V[., chunk]; where all k rows of a
//   chunk wider than the consumers' 16-byte groups do not fit, the chunk is
//   swept in ceil(k / rows) stages while the consumers keep the partial
//   sums of out in registers, so no byte is read twice.
// * rank_k_axpy_direct, for small P, unaligned V and as the other candidate:
//   tiles of kAxpyUnroll groups per thread, each row's loads issued before
//   its FMAs, streaming (evict-first) loads.  For a small P the grid is
//   sized to P (one tile per block) rather than to the occupancy.
// * Alignment is per operand.  out is the wrapper's, always aligned.  V's
//   rows are read in 16-byte vectors whenever V's base and P * es are
//   aligned; g, which may be a slice of a flat gradient, is read in 16-byte
//   vectors (or bulk copies) when it is aligned and one element at a time
//   otherwise -- its phase against V's groups cannot be fixed by a head.
//   Only an unaligned V drops V's loads to one element at a time.
// * Every path sums w[j] V[j, p] in f32 in row order and then adds g[p], so
//   results repeat bit for bit and do not depend on the plan.  The ragged
//   end of P needs no padding in either pass (the TPU wrapper padded V, a
//   full copy of V per call); offsets into V are 64-bit (k * P > 2^31 at
//   k = 35, P = 124M).
// * The bf16 kernels read bf16 V but keep g and w in f32, so they are MORE
//   exact than the plain rank_k_apply_bf16, which also rounds g and w to bf16.
// The path, grid, chunk, rows, stages and shared-memory bytes are
// ops/kernels.py::axpy_plan's; the launch only checks that they fit.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // pass 2's direct kernel
constexpr int kMaxRows = 16;
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kRingThreads = 32 + kConsumers;  // warp 0 produces
constexpr int kMaxStages = 8;
// slack of each slot of pass 1's shifted ring: room for an operand placed
// at its own offset within 128 bytes (slot_offset)
constexpr int kShiftPad = 128;

// Where element 0 of an operand's chunk at `a` sits in its 128-byte aligned
// slot of the shifted ring: at a's offset within its 128 bytes, so that a
// bulk copy's destination lies against 128-byte lines as its source does
// (16-byte slots, which moved every copy off its source's lines, ran 2-5%
// slower at the unaligned rows: PERF.md).  The same in every chunk, as a
// chunk is whole 128-byte lines of g and of each row.
__device__ __forceinline__ uint32_t slot_offset(const void* a) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(a) & 127);
}

// The low 16 bits of `bits` as a bf16, widened to f32 (exact).
__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// 16-byte vectors of a row, read from a shared-memory stage (both rings).
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

// VEC elements of a pass-1 slot at p, whose address mod 16 is `shift` (its
// operand's, the same for the whole block): 16-byte loads where it is 0,
// else the widest loads its alignment allows.
template <int VEC>
__device__ __forceinline__ void lds_shifted(const float* p, uint32_t shift, float (&x)[VEC]) {
  if (shift == 0) {
    lds_row<VEC>(p, x);
  } else if ((shift & 7) == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) {
      const float2 v = reinterpret_cast<const float2*>(p)[q];
      x[2 * q + 0] = v.x;
      x[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) x[q] = p[q];
  }
}

template <int VEC>
__device__ __forceinline__ void lds_shifted(const __nv_bfloat16* p, uint32_t shift,
                                            float (&x)[VEC]) {
  if (shift == 0) {
    lds_row<VEC>(p, x);
  } else if ((shift & 3) == 0) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) {
      const uint32_t h = u[q];
      x[2 * q + 0] = bf16_bits_to_f32(h & 0xffffu);
      x[2 * q + 1] = __uint_as_float(h & 0xffff0000u);
    }
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int q = 0; q < VEC; ++q) x[q] = bf16_bits_to_f32(u[q]);
  }
}

// The last, partial group of P: its `lim` elements, zeros after them.
template <int VEC>
__device__ __forceinline__ void lds_part(const float* p, int lim, float (&x)[VEC]) {
#pragma unroll
  for (int q = 0; q < VEC; ++q) x[q] = q < lim ? p[q] : 0.f;
}

template <int VEC>
__device__ __forceinline__ void lds_part(const __nv_bfloat16* p, int lim, float (&x)[VEC]) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int q = 0; q < VEC; ++q) x[q] = q < lim ? bf16_bits_to_f32(u[q]) : 0.f;
}

// A group of pass 1's elements e .. e + VEC of an operand's slot (p points
// at element e); lim = the elements of the chunk from e on.
template <int VEC, bool kShift, typename T>
__device__ __forceinline__ void lds_group(const T* p, uint32_t shift, int lim, float (&x)[VEC]) {
  if constexpr (!kShift) {
    lds_row<VEC>(p, x);  // aligned plan: P is whole groups, every shift 0
  } else if (lim >= VEC) {
    lds_shifted<VEC>(p, shift, x);
  } else {
    lds_part<VEC>(p, lim, x);
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

// Pass 1's sums: every run of a thread's f32 products goes, summed over its
// warp by a shuffle tree, into the warp's double for the row, wsum[warp][r]
// (lane r adds it); the thread's f32 sums restart from 0.  nr is the same
// for the whole block, so no lane skips a shuffle.
__device__ __forceinline__ void flush_rows(float (&acc)[kMaxRows],
                                           double (&wsum)[kConsumerWarps][kMaxRows], int t,
                                           int nr) {
  const int lane = t & 31;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < nr) {
      float s = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == r) wsum[t >> 5][r] += static_cast<double>(s);
      acc[r] = 0.f;
    }
  }
}

// Only the consumer warps take part (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// Each warp clears its own doubles before a sweep of rows.
__device__ __forceinline__ void clear_rows(double (&wsum)[kConsumerWarps][kMaxRows], int t) {
  if ((t & 31) < kMaxRows) wsum[t >> 5][t & 31] = 0.0;
  __syncwarp();
}

// One thread per row adds the eight warps' doubles in a fixed order into
// partials[r0 + t, block].
__device__ __forceinline__ void write_partials(double (&wsum)[kConsumerWarps][kMaxRows], int t,
                                               int nr, int r0, float* __restrict__ partials) {
  consumer_sync();
  if (t < nr) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) s += wsum[w][t];
    partials[static_cast<int64_t>(r0 + t) * gridDim.x + blockIdx.x] = static_cast<float>(s);
  }
  consumer_sync();
}

// Where one operand's chunk [pos, pos + n) of `es`-byte elements lies
// against 16-byte boundaries: `head` elements before the first (all n if
// the chunk ends first), then `bytes` of whole 16-byte vectors from `src`,
// then the rest (fewer than 16 bytes).
struct Piece {
  const unsigned char* src;
  uint32_t head;
  uint32_t bytes;
};

__device__ __forceinline__ Piece piece(const void* base, uint32_t es, int64_t pos, int n) {
  const unsigned char* a = static_cast<const unsigned char*>(base) + pos * es;
  const uint32_t shift = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(a) & 15);
  const uint32_t head = min(((16u - shift) & 15u) / es, static_cast<uint32_t>(n));
  const uint32_t bytes = ((static_cast<uint32_t>(n) - head) * es) & ~15u;
  return {a + head * es, head, bytes};
}

// The bytes of an operand's chunk that no bulk copy moves -- its head and
// its tail, fewer than 16 bytes each -- loaded from global memory and
// stored at their place in the operand's slot, element e at byte
// shift + e * es.
template <typename T>
__device__ __forceinline__ void copy_ends(const T* base, unsigned char* slot, int64_t pos, int n) {
  using Bits = typename std::conditional<sizeof(T) == 2, unsigned short, unsigned int>::type;
  constexpr int kEnd = 16 / sizeof(T) - 1;  // most elements at one end
  const Piece pc = piece(base, sizeof(T), pos, n);
  const Bits* src = reinterpret_cast<const Bits*>(base + pos);
  Bits* dst = reinterpret_cast<Bits*>(slot + slot_offset(src));
  const int tail = static_cast<int>(pc.head + pc.bytes / sizeof(T));
  Bits x[2 * kEnd];
#pragma unroll
  for (int i = 0; i < kEnd; ++i) {
    if (i < static_cast<int>(pc.head)) x[i] = __ldg(src + i);
    if (tail + i < n) x[kEnd + i] = __ldg(src + tail + i);
  }
#pragma unroll
  for (int i = 0; i < kEnd; ++i) {
    if (i < static_cast<int>(pc.head)) dst[i] = x[i];
    if (tail + i < n) dst[tail + i] = x[kEnd + i];
  }
}

// Pass 1: w[j] = coef[j] * sum_p V[j, p] g[p].  Shared memory: `stages`
// stages, each a slot of g[chunk] (f32) then `rows` slots of V[r, chunk];
// with kShift every slot has kShiftPad bytes of slack and holds its
// operand from slot_offset.  scratch: the count of finished blocks
// (4 bytes, 0 between launches), 12 bytes of padding, then partials (k,
// nblocks) f32.
template <typename T, int VEC, bool kShift>
__global__ void __launch_bounds__(kRingThreads)
rank_k_dots_kernel(const T* __restrict__ V, const float* __restrict__ g,
                   const float* __restrict__ coef, unsigned char* __restrict__ scratch,
                   float* __restrict__ w, int k, int64_t P, int chunk, int stages, int rows) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ double wsum[kConsumerWarps][kMaxRows];
  __shared__ int last_block;

  unsigned int* done = reinterpret_cast<unsigned int*>(scratch);
  float* partials = reinterpret_cast<float*>(scratch + 16);
  const int64_t nchunks = (P + chunk - 1) / chunk;  // block b takes chunks b, b + grid, ...
  const size_t pad = kShift ? kShiftPad : 0;
  const size_t g_slot = static_cast<size_t>(chunk) * sizeof(float) + pad;
  const size_t v_slot = static_cast<size_t>(chunk) * sizeof(T) + pad;
  const size_t stage_bytes = g_slot + static_cast<size_t>(rows) * v_slot;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], kShift ? 32 : 1);  // kShift: the copying thread and 31 lanes of ends
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // producer warp
    const int lane = threadIdx.x;
    if (kShift || lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int r0 = 0; r0 < k; r0 += rows) {
        const int nr = min(rows, k - r0);
        const T* V0 = V + static_cast<int64_t>(r0) * P;
        for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
          mbar_wait(&empty[s], phase ^ 1);  // first pass over the ring: free
          const int64_t pos = c * chunk;
          const int n = static_cast<int>(P - pos < chunk ? P - pos : chunk);
          unsigned char* st = ring + s * stage_bytes;
          if (lane == 0) {  // the bulk copies of every operand's interior
            const Piece pg = piece(g, sizeof(float), pos, n);
            uint32_t tx = pg.bytes;
            for (int r = 0; r < nr; ++r) tx += piece(V0 + r * P, sizeof(T), pos, n).bytes;
            mbar_arrive_expect_tx(&full[s], tx);
            if (pg.bytes) {
              bulk_load(st + (kShift ? slot_offset(g + pos) : 0) + pg.head * sizeof(float), pg.src,
                        pg.bytes, &full[s]);
            }
            for (int r = 0; r < nr; ++r) {
              const Piece pv = piece(V0 + r * P, sizeof(T), pos, n);
              const size_t at = g_slot + r * v_slot +
                                (kShift ? slot_offset(V0 + r * P + pos) : 0) + pv.head * sizeof(T);
              if (pv.bytes) bulk_load(st + at, pv.src, pv.bytes, &full[s]);
            }
          }
          if constexpr (kShift) {
            // the copies are in flight before the other lanes wait on
            // their loads of the ends
            __syncwarp();
          }
          if (kShift && lane > 0) {  // lanes 1-31: the ends, one operand each
            for (int o = lane - 1; o <= nr; o += 31) {
              if (o == 0) {
                copy_ends<float>(g, st, pos, n);
              } else {
                copy_ends<T>(V0 + static_cast<int64_t>(o - 1) * P, st + g_slot + (o - 1) * v_slot,
                             pos, n);
              }
            }
            // A slot holds one row at one shift for a whole sweep, so its
            // ends and its interior are the same bytes from chunk to chunk;
            // the next sweep's bulk copies may write where these stores did:
            // order them (a proxy fence, once a sweep: it waits for the
            // warp's copies in flight).
            if (c + gridDim.x >= nchunks) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            mbar_arrive(&full[s]);
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
  const uint32_t g_at = kShift ? slot_offset(g) : 0;  // g's place in its slot; & 15: its shift
  int s = 0;
  uint32_t phase = 0;
  for (int r0 = 0; r0 < k; r0 += rows) {
    const int nr = min(rows, k - r0);
    uint32_t v_at[kMaxRows];  // each row's place in its slot; & 15: its shift
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      v_at[r] = kShift && r < nr ? slot_offset(V + static_cast<int64_t>(r0 + r) * P) : 0;
    clear_rows(wsum, t);
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;

    for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
      mbar_wait(&full[s], phase);
      const int64_t left = P - c * chunk;
      const int n = static_cast<int>(left < chunk ? left : chunk);
      const unsigned char* st = ring + s * stage_bytes;
      const float* gs = reinterpret_cast<const float*>(st + g_at);
      for (int e = t * VEC; e < n; e += kConsumers * VEC) {
        const int lim = n - e;
        float gv[VEC];
        lds_group<VEC, kShift>(gs + e, g_at & 15, lim, gv);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < nr) {
            float vv[VEC];
            lds_group<VEC, kShift>(
                reinterpret_cast<const T*>(st + g_slot + r * v_slot + v_at[r]) + e, v_at[r] & 15,
                lim, vv);
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[r] = fmaf(vv[q], gv[q], acc[r]);
          }
        }
      }
      __syncwarp();
      if ((t & 31) == 0) mbar_arrive(&empty[s]);
      if (++s == stages) {  // one pass over the ring: the end of a run
        s = 0;
        phase ^= 1;
        flush_rows(acc, wsum, t, nr);
      }
    }
    flush_rows(acc, wsum, t, nr);
    write_partials(wsum, t, nr, r0, partials);
  }

  // The last block to finish sums the partials of every row in a fixed
  // order (no atomic touches a sum) and resets the count for the next launch.
  __threadfence();  // this block's partials before its count
  consumer_sync();
  if (t == 0) last_block = atomicAdd(done, 1u) == gridDim.x - 1;
  consumer_sync();
  if (!last_block) return;
  __threadfence();
  const int lane = t & 31;
  for (int j = t >> 5; j < k; j += kConsumerWarps) {
    const float* row = partials + static_cast<int64_t>(j) * gridDim.x;
    double sum = 0.0;
    for (int b = lane; b < static_cast<int>(gridDim.x); b += 32) sum += __ldcg(row + b);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) w[j] = static_cast<float>(static_cast<double>(coef[j]) * sum);
  }
  if (t == 0) *done = 0u;
}

// ---- Pass 2: out[p] = g[p] + sum_j w[j] * V[j, p] ---------------------------
//
// Every path sums w[j] * V[j, p] in f32 in row order (fmaf), then adds g[p]:
// the same operations on every element, so all paths and plans give the same
// bits.  Elements go in groups of VEC (one 16-byte vector of a row of V);
// out is allocated by the wrapper, so its groups are always 16-byte aligned.

// A group of VEC elements of a row of V (or of g), widened to f32, by
// streaming (evict-first) loads -- every element of V and g is read once:
// one 16-byte load per 16 bytes when kVec, else one load per element (a
// pointer that is not 16-byte aligned).
template <int VEC, bool kVec>
__device__ __forceinline__ void ldcs_group(const float* __restrict__ p, float (&x)[VEC]) {
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(p) + q);
      x[4 * q + 0] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) x[q] = __ldcs(p + q);
  }
}

template <int VEC, bool kVec>
__device__ __forceinline__ void ldcs_group(const __nv_bfloat16* __restrict__ p, float (&x)[VEC]) {
  static_assert(VEC == 8, "bf16 groups are 8 elements (16 bytes)");
  if constexpr (kVec) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t h[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[2 * q + 0] = bf16_bits_to_f32(h[q] & 0xffffu);
      x[2 * q + 1] = __uint_as_float(h[q] & 0xffff0000u);
    }
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int q = 0; q < VEC; ++q) x[q] = bf16_bits_to_f32(__ldcs(u + q));
  }
}

__device__ __forceinline__ float ldcs_one(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float ldcs_one(const __nv_bfloat16* p) {
  return bf16_bits_to_f32(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}

// out[e .. e + VEC) = g + acc, 16-byte streaming stores.
template <int VEC>
__device__ __forceinline__ void stcs_sum(float* __restrict__ out, const float (&gv)[VEC],
                                         const float (&acc)[VEC]) {
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    __stcs(reinterpret_cast<float4*>(out) + q,
           make_float4(gv[4 * q + 0] + acc[4 * q + 0], gv[4 * q + 1] + acc[4 * q + 1],
                       gv[4 * q + 2] + acc[4 * q + 2], gv[4 * q + 3] + acc[4 * q + 3]));
  }
}

// The last P mod VEC elements, one thread each, by the grid's last block.
template <typename T, int VEC>
__device__ __forceinline__ void axpy_tail(const T* __restrict__ V, const float* __restrict__ g,
                                          const float* ws, float* __restrict__ out, int k,
                                          int64_t P, int t) {
  const int64_t i = P / VEC * VEC + t;
  if (blockIdx.x != gridDim.x - 1 || i >= P) return;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) acc = fmaf(ws[j], ldcs_one(V + static_cast<int64_t>(j) * P + i), acc);
  out[i] = __ldcs(g + i) + acc;
}

constexpr int kAxpyUnroll = 2;  // groups per thread per tile of the direct path

// Pass 2, direct path: block b takes tiles b, b + grid, ... of kAxpyUnroll x
// kThreads groups; each thread issues its kAxpyUnroll loads of a row before
// the row's FMAs (the row loop is unrolled twice), so a warp keeps
// 2 x 512 bytes of every row in flight.  kVecV / kVecG: V's rows / g in
// 16-byte loads.  w in shared memory (k <= 12288: 48 KB).
template <typename T, int VEC, bool kVecV, bool kVecG>
__global__ void __launch_bounds__(kThreads)
rank_k_axpy_direct(const T* __restrict__ V, const float* __restrict__ g,
                   const float* __restrict__ w, float* __restrict__ out, int k, int64_t P) {
  extern __shared__ float ws[];
  for (int j = threadIdx.x; j < k; j += kThreads) ws[j] = w[j];
  __syncthreads();
  const int64_t ngroups = P / VEC;
  constexpr int64_t kTile = static_cast<int64_t>(kAxpyUnroll) * kThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x; base < ngroups;
       base += static_cast<int64_t>(gridDim.x) * kTile) {
    int64_t e[kAxpyUnroll];
    bool live[kAxpyUnroll];
#pragma unroll
    for (int u = 0; u < kAxpyUnroll; ++u) {
      live[u] = base + u * kThreads < ngroups;
      e[u] = (base + u * kThreads) * VEC;
    }
    float acc[kAxpyUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kAxpyUnroll; ++u)
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[u][q] = 0.f;
#pragma unroll 2
    for (int j = 0; j < k; ++j) {
      const T* row = V + static_cast<int64_t>(j) * P;
      float vv[kAxpyUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kAxpyUnroll; ++u)
        if (live[u]) ldcs_group<VEC, kVecV>(row + e[u], vv[u]);
      const float wj = ws[j];
#pragma unroll
      for (int u = 0; u < kAxpyUnroll; ++u)
        if (live[u]) {
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[u][q] = fmaf(wj, vv[u][q], acc[u][q]);
        }
    }
#pragma unroll
    for (int u = 0; u < kAxpyUnroll; ++u)
      if (live[u]) {
        float gv[VEC];
        ldcs_group<VEC, kVecG>(g + e[u], gv);
        stcs_sum<VEC>(out + e[u], gv, acc[u]);
      }
  }
  axpy_tail<T, VEC>(V, g, ws, out, k, P, threadIdx.x);
}

constexpr int kRingVecs = 2;  // most 16-byte groups of a stage row per consumer

// Pass 2, ring path: one wave of persistent blocks; block b takes chunks b,
// b + grid, ... of P.  Warp 0's first thread streams each chunk into the ring
// with bulk copies: g[chunk] (kBulkG) with the first sweep, then `rows` rows
// of V[., chunk] per stage, ceil(k / rows) sweeps per chunk.  Eight consumer
// warps keep their groups' sums in registers across the sweeps, add g and
// store out with 16-byte streaming stores.  Needs P a multiple of VEC and V
// (and, with kBulkG, g) 16-byte aligned; g otherwise comes from global
// memory, one load per element.  Shared memory: w (k floats, rounded up to
// 128 bytes), then `stages` stages of [g[chunk] if kBulkG][rows x chunk].
template <typename T, int VEC, bool kBulkG>
__global__ void __launch_bounds__(kRingThreads)
rank_k_axpy_ring(const T* __restrict__ V, const float* __restrict__ g,
                 const float* __restrict__ w, float* __restrict__ out, int k, int64_t P,
                 int chunk, int stages, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  float* ws = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + ((static_cast<size_t>(k) * sizeof(float) + 127) / 128) * 128;
  const size_t g_bytes = kBulkG ? static_cast<size_t>(chunk) * sizeof(float) : 0;
  const size_t stage_bytes = g_bytes + static_cast<size_t>(rows) * chunk * sizeof(T);
  const int64_t nchunks = (P + chunk - 1) / chunk;

  for (int j = threadIdx.x; j < k; j += kRingThreads) ws[j] = w[j];
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
      for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
        const int64_t pos = c * chunk;
        const uint32_t n = static_cast<uint32_t>(P - pos < chunk ? P - pos : chunk);
        for (int r0 = 0; r0 < k; r0 += rows) {
          const int nr = min(rows, k - r0);
          mbar_wait(&empty[s], phase ^ 1);  // first pass over the ring: free
          unsigned char* st = ring + s * stage_bytes;
          T* vs = reinterpret_cast<T*>(st + g_bytes);
          const bool with_g = kBulkG && r0 == 0;
          mbar_arrive_expect_tx(&full[s], n * static_cast<uint32_t>(nr * sizeof(T) +
                                                                  (with_g ? sizeof(float) : 0)));
          if (with_g) bulk_load(st, g + pos, n * sizeof(float), &full[s]);
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
  for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const int64_t pos = c * chunk;
    const int n = static_cast<int>(P - pos < chunk ? P - pos : chunk);
    float acc[kRingVecs][VEC];
    float gv[kRingVecs][VEC];
#pragma unroll
    for (int u = 0; u < kRingVecs; ++u)
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[u][q] = 0.f;
    for (int r0 = 0; r0 < k; r0 += rows) {
      const int nr = min(rows, k - r0);
      mbar_wait(&full[s], phase);
      const unsigned char* st = ring + s * stage_bytes;
      const T* vs = reinterpret_cast<const T*>(st + g_bytes);
#pragma unroll
      for (int u = 0; u < kRingVecs; ++u) {
        const int e = (u * kConsumers + t) * VEC;
        if (e < n) {
          if (kBulkG && r0 == 0) lds_row<VEC>(reinterpret_cast<const float*>(st) + e, gv[u]);
#pragma unroll 4
          for (int r = 0; r < nr; ++r) {
            float vv[VEC];
            lds_row<VEC>(vs + static_cast<size_t>(r) * chunk + e, vv);
            const float wr = ws[r0 + r];
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[u][q] = fmaf(wr, vv[q], acc[u][q]);
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
#pragma unroll
    for (int u = 0; u < kRingVecs; ++u) {
      const int e = (u * kConsumers + t) * VEC;
      if (e < n) {
        if (!kBulkG) ldcs_group<VEC, false>(g + pos + e, gv[u]);
        stcs_sum<VEC>(out + pos + e, gv[u], acc[u]);
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&allowed)[16]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 16) allowed[dev] = bytes;
  return err;
}

template <typename T, int VEC, bool kShift>
int launch_dots_ring(const T* V, const float* g, const float* c, unsigned char* scratch, float* w,
                     int k, int64_t P, int nblocks, int chunk, int stages, int rows,
                     int smem_bytes, cudaStream_t s) {
  static int allowed[16] = {0};
  cudaError_t err = allow_smem(rank_k_dots_kernel<T, VEC, kShift>, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_k_dots_kernel<T, VEC, kShift><<<nblocks, kRingThreads, smem_bytes, s>>>(
      V, g, c, scratch, w, k, P, chunk, stages, rows);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1's launch as ops/kernels.py::dots_plan made it.  The launch only
// checks that the plan fits what it is given: the ring's stages in
// `smem_bytes`, its chunks in whole 16-byte groups (128-byte lines on the
// shifted ring), and an aligned plan's operands aligned.
template <typename T, int VEC>
int launch_dots(const void* Vp, const void* gp, const void* cp, void* scratchp, void* wp, int k,
                int64_t P, int nblocks, int aligned, int chunk, int stages, int rows,
                int smem_bytes, cudaStream_t s) {
  const T* V = static_cast<const T*>(Vp);
  const float* g = static_cast<const float*>(gp);
  const int64_t pad = aligned ? 0 : kShiftPad;
  const int64_t stage = static_cast<int64_t>(chunk) * static_cast<int64_t>(sizeof(float) +
                                                                           rows * sizeof(T)) +
                        pad * (rows + 1);
  const bool vec = ((reinterpret_cast<uintptr_t>(Vp) | reinterpret_cast<uintptr_t>(gp)) & 15) == 0 &&
                   P % VEC == 0;
  if (k < 1 || P < 1 || nblocks < 1 || rows < 1 || rows > kMaxRows || stages < 1 ||
      stages > kMaxStages || chunk < VEC || chunk % VEC != 0 || (aligned && !vec) ||
      (!aligned && chunk % (128 / static_cast<int>(sizeof(T))) != 0) || stages * stage > smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* c = static_cast<const float*>(cp);
  unsigned char* scratch = static_cast<unsigned char*>(scratchp);
  float* w = static_cast<float*>(wp);
  return aligned ? launch_dots_ring<T, VEC, false>(V, g, c, scratch, w, k, P, nblocks, chunk,
                                                    stages, rows, smem_bytes, s)
                 : launch_dots_ring<T, VEC, true>(V, g, c, scratch, w, k, P, nblocks, chunk,
                                                   stages, rows, smem_bytes, s);
}

// Blocks of pass 1's aligned or shifted ring that fit on one SM at once.
template <typename T, int VEC, bool kShift>
int dots_ring_blocks_per_sm(int smem_bytes, int* blocks) {
  static int allowed[16] = {0};
  cudaError_t err = allow_smem(rank_k_dots_kernel<T, VEC, kShift>, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rank_k_dots_kernel<T, VEC, kShift>, kRingThreads, smem_bytes));
}

template <typename T, int VEC>
int dots_blocks_per_sm(int aligned, int smem_bytes, int* blocks) {
  return aligned ? dots_ring_blocks_per_sm<T, VEC, false>(smem_bytes, blocks)
                 : dots_ring_blocks_per_sm<T, VEC, true>(smem_bytes, blocks);
}

template <typename T, int VEC, bool kBulkG>
int launch_axpy_ring(const T* V, const float* g, const float* w, float* out, int k, int64_t P,
                     int nblocks, int chunk, int stages, int rows, int smem_bytes, cudaStream_t s) {
  static int allowed[16] = {0};
  cudaError_t err = allow_smem(rank_k_axpy_ring<T, VEC, kBulkG>, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_k_axpy_ring<T, VEC, kBulkG><<<nblocks, kRingThreads, smem_bytes, s>>>(V, g, w, out, k, P,
                                                                            chunk, stages, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, bool kVecV, bool kVecG>
int launch_axpy_direct(const T* V, const float* g, const float* w, float* out, int k, int64_t P,
                       int nblocks, int smem_bytes, cudaStream_t s) {
  rank_k_axpy_direct<T, VEC, kVecV, kVecG><<<nblocks, kThreads, smem_bytes, s>>>(V, g, w, out, k,
                                                                                P);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2's launch as ops/kernels.py::axpy_plan made it.  The launch only
// checks that the plan fits what it is given: the ring's stages in
// `smem_bytes`, its chunks in whole 16-byte groups, its rows within k.
template <typename T, int VEC>
int launch_axpy(const void* Vp, const void* gp, const void* wp, void* outp, int k, int64_t P,
                int nblocks, int ring, int vec_v, int vec_g, int chunk, int stages, int rows,
                int smem_bytes, cudaStream_t s) {
  const T* V = static_cast<const T*>(Vp);
  const float* g = static_cast<const float*>(gp);
  const float* w = static_cast<const float*>(wp);
  float* out = static_cast<float*>(outp);
  const int64_t w_bytes = (static_cast<int64_t>(k) * 4 + 127) / 128 * 128;
  if (nblocks < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (ring) {
    const int64_t stage = (vec_g ? static_cast<int64_t>(chunk) * 4 : 0) +
                          static_cast<int64_t>(rows) * chunk * static_cast<int64_t>(sizeof(T));
    if (!vec_v || P % VEC != 0 || stages < 1 || stages > kMaxStages || chunk < VEC ||
        chunk % VEC != 0 || chunk > kRingVecs * kConsumers * VEC || rows < 1 || rows > k ||
        w_bytes + stages * stage > smem_bytes)
      return static_cast<int>(cudaErrorInvalidValue);
    return vec_g ? launch_axpy_ring<T, VEC, true>(V, g, w, out, k, P, nblocks, chunk, stages, rows,
                                                  smem_bytes, s)
                 : launch_axpy_ring<T, VEC, false>(V, g, w, out, k, P, nblocks, chunk, stages, rows,
                                                   smem_bytes, s);
  }
  if (static_cast<int64_t>(k) * 4 > smem_bytes || smem_bytes > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_v) {
    return vec_g ? launch_axpy_direct<T, VEC, true, true>(V, g, w, out, k, P, nblocks, smem_bytes, s)
                 : launch_axpy_direct<T, VEC, true, false>(V, g, w, out, k, P, nblocks, smem_bytes, s);
  }
  return vec_g ? launch_axpy_direct<T, VEC, false, true>(V, g, w, out, k, P, nblocks, smem_bytes, s)
               : launch_axpy_direct<T, VEC, false, false>(V, g, w, out, k, P, nblocks, smem_bytes, s);
}

// Blocks of the chosen pass-2 kernel that fit on one SM at once.
template <typename T, int VEC>
int axpy_blocks_per_sm(int ring, int smem_bytes, int* blocks) {
  if (!ring) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, rank_k_axpy_direct<T, VEC, true, true>, kThreads, smem_bytes));
  }
  static int allowed[16] = {0};
  cudaError_t err = allow_smem(rank_k_axpy_ring<T, VEC, true>, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rank_k_axpy_ring<T, VEC, true>, kRingThreads, smem_bytes));
}

}  // namespace

extern "C" {

// Pass 1, w = c * (V g), on the ring of `stages` stages of `chunk`
// elements in `smem_bytes` of dynamic shared memory.  plan: k, nblocks,
// aligned, chunk, stages, rows, smem_bytes (one array, so a call converts
// fewer arguments).  aligned != 0: V, g 16-byte aligned and P a multiple of
// 4 (f32) / 8 (bf16) elements; else the shifted ring, any alignment.
// scratch: 16 bytes whose first 4 are 0 (the kernel leaves them 0), then
// k * nblocks floats.  Plan: ops/kernels.py::dots_plan.
int rank_k_dots_f32(const void* V, const void* g, const void* c, void* scratch, void* w,
                    long long P, const int* plan, void* stream) {
  return launch_dots<float, 4>(V, g, c, scratch, w, plan[0], P, plan[1], plan[2], plan[3],
                               plan[4], plan[5], plan[6], static_cast<cudaStream_t>(stream));
}

int rank_k_dots_bf16(const void* V, const void* g, const void* c, void* scratch, void* w,
                     long long P, const int* plan, void* stream) {
  return launch_dots<__nv_bfloat16, 8>(V, g, c, scratch, w, plan[0], P, plan[1], plan[2], plan[3],
                                       plan[4], plan[5], plan[6],
                                       static_cast<cudaStream_t>(stream));
}

int rank_k_dots_blocks_per_sm_f32(int aligned, int smem_bytes, int* blocks) {
  return dots_blocks_per_sm<float, 4>(aligned, smem_bytes, blocks);
}

int rank_k_dots_blocks_per_sm_bf16(int aligned, int smem_bytes, int* blocks) {
  return dots_blocks_per_sm<__nv_bfloat16, 8>(aligned, smem_bytes, blocks);
}

// Pass 2.  ring != 0: the bulk-copy ring (V 16-byte aligned, P a multiple of
// 4 (f32) / 8 (bf16); vec_g: g also aligned and copied in bulk); else the
// direct kernel (vec_v / vec_g: V's rows / g in 16-byte loads).  Plan:
// ops/kernels.py::axpy_plan.
int rank_k_axpy_f32(const void* V, const void* g, const void* w, void* out, int k, long long P,
                    int nblocks, int ring, int vec_v, int vec_g, int chunk, int stages, int rows,
                    int smem_bytes, void* stream) {
  return launch_axpy<float, 4>(V, g, w, out, k, P, nblocks, ring, vec_v, vec_g, chunk, stages,
                               rows, smem_bytes, static_cast<cudaStream_t>(stream));
}

int rank_k_axpy_bf16(const void* V, const void* g, const void* w, void* out, int k, long long P,
                     int nblocks, int ring, int vec_v, int vec_g, int chunk, int stages, int rows,
                     int smem_bytes, void* stream) {
  return launch_axpy<__nv_bfloat16, 8>(V, g, w, out, k, P, nblocks, ring, vec_v, vec_g, chunk,
                                       stages, rows, smem_bytes, static_cast<cudaStream_t>(stream));
}

int rank_k_axpy_blocks_per_sm_f32(int ring, int smem_bytes, int* blocks) {
  return axpy_blocks_per_sm<float, 4>(ring, smem_bytes, blocks);
}

int rank_k_axpy_blocks_per_sm_bf16(int ring, int smem_bytes, int* blocks) {
  return axpy_blocks_per_sm<__nv_bfloat16, 8>(ring, smem_bytes, blocks);
}

}  // extern "C"
