// Ring-window copy probe on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kernel` launched by `main` in
// tools/dma_probe.py. That probe checked, before the streamed-ring AR
// kernel depended on it, that a ring held in device memory persists
// across the steps of a sequential grid and that a window of it can be
// copied in and out by asynchronous copies with a completion wait. This
// kernel checks the Hopper forms of the same mechanism, and times them.
//
// What it computes: a ring of `per` windows of (chunk, R) fp32 per batch
// row, zeroed by the caller. Chunk i copies window i mod per in, adds 1,
// writes it to chunk i of the output and copies it back. So every value of
// output chunk i is i // per + 1 (the TPU probe's check), and a stale
// window, a copy that has not landed, or a write-back that a later load
// does not see shows up as a wrong chunk value, not as a crash. The ring
// is (B, per * chunk, R), so a row's window, and any run of its t rows, is
// one contiguous run of bytes; the output keeps the TPU probe's (n_chunks *
// chunk, B, R) layout, so each t row of a chunk is one run of R * 4 bytes.
//
// What bounds it: bytes. The output (n_chunks * chunk * B * R fp32) must
// reach device memory and the ring is zeroed once per run: 0.0852 ms at
// 3.35 TB/s for B = 132, 64 chunks. The copies in and back (twice the
// output's bytes) stay in the 50 MB L2 where the ring fits. And a chain:
// chunk i's load needs chunk i - per's write-back landed, so every `per`
// chunks cost one write-back and one load round trip to L2, whatever the
// bandwidth.
//
// Two designs, four variants (`ring_probe` and `ring_probe_pipe` below):
//
// The block-for-block port, `ring_probe_kernel` (variants tma and cp_async):
// one block per batch row loops over the chunks (the TPU probe's
// sequential grid), the row's whole window in shared memory, every step
// serial: the load with the whole block waiting, the +1 and the output
// stores, the write-back, a block barrier.
//   kTma      one thread issues a bulk copy (cp.async.bulk, the TMA's
//             non-tensor form) of the whole window global -> shared that
//             completes on an mbarrier; after the +1 (generic-proxy stores
//             into the window) every thread fences the async proxy and,
//             past a block barrier, one thread issues the bulk copy back
//             and waits for it to complete (cp.async.bulk.wait_group 0):
//             the TPU probe's make_async_copy + DMA semaphore.
//   kCpAsync  every thread issues 16-byte cp.async.cg copies of its part of
//             the window, then cp.async.wait_group 0 and a block barrier;
//             the write-back is plain stores.
//
// The redesign for this card, `ring_pipe_kernel` (variants tma_pipe and
// cp_async_pipe; one template, the copy form its parameter):
// - Each row's window is split by its t rows over `blocks_per_row` blocks
//   of `rows_per_block` rows (the last may hold fewer), so a small batch
//   fills the card and a large one keeps several pieces in flight per SM.
//   A piece's history is its own and its owner is the same block in every
//   chunk, so no block ever waits for another. The split is the wrapper's
//   (ops/ring_probe.py `split`), a plain function of the shape, the SM
//   count and a block's shared memory.
// - Each block pipelines the chunks through `stages` shared-memory stages
//   (chunk j in stage j mod stages). Warp 4 is the producer, warps 0-3 the
//   consumers: the consumers wait on the stage's `full` mbarrier, add 1
//   and arrive on its `ready` mbarrier; the producer issues the load of
//   chunk j = i + lookahead, then waits for chunk i's `ready`. The load of
//   chunk j needs chunk j - per's write-back landed, so the lookahead is
//   min(stages - 1, per - 1): at per = 2 chunk i + 1's load overlaps chunk
//   i's +1, output and write-back.
//   kBulkCopy (tma_pipe) one elected thread (the producer warp's lane 0)
//             issues every copy: the piece in by one bulk copy completing
//             on `full`; after `ready` (each consumer fenced the async
//             proxy after its +1 in place), the write-back by one bulk
//             copy, committed as its own bulk group, then the output by
//             one bulk copy per t row, a second group. Before a load it
//             waits for the write-back it reads (cp.async.bulk.wait_group
//             N, the newer groups left in flight) and for the stores that
//             read the stage it refills (wait_group.read N).
//   kCpAsyncCopy (cp_async_pipe, the cluster kernel's weight-stage form) the
//             producer warp's 32 lanes issue 16-byte cp.async.cg copies of
//             the piece, each lane's completion arriving on `full`
//             (cp.async.mbarrier.arrive.noinc); the consumers store the
//             window out and back with plain 16-byte stores before they
//             arrive on `ready`, whose release and the producer's acquire
//             order those stores before the later cp.async read of the
//             slot.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kErrShape = -1, kErrVariant = -2, kErrSharedMemory = -3,
              kErrSplit = -4;
enum Variant : int { kTma = 0, kCpAsync = 1 };
// the pipelined kernel: its copy form, warps and most stages (its mbarriers
// are static shared memory, 2 * kMaxStages * 8 bytes beside the stages)
enum Copy : int { kBulkCopy = 0, kCpAsyncCopy = 1 };
constexpr int kConsumerWarps = 4;
constexpr int kPipeThreads = (kConsumerWarps + 1) * 32;
constexpr int kMaxStages = 8;
constexpr uint64_t kWaitTrapNs = 2000000000ull;   // 2 s

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ring_probe_kernel(float* ring, float* out, int B, int chunk, int R, int per,
                  int n_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  float* win = reinterpret_cast<float*>(smem);
  const int row = blockIdx.x, tid = threadIdx.x;
  const int n = chunk * R;                     // window elements
  const uint32_t bytes = (uint32_t)n * sizeof(float);
  float* ring_row = ring + (size_t)row * per * n;
  const uint32_t win_s = smem_u32(win), bar_s = smem_u32(&bar);

  if constexpr (V == kTma) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_s)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int i = 0; i < n_chunks; ++i) {
    float* slot = ring_row + (size_t)(i % per) * n;
    // -- the window in
    if constexpr (V == kTma) {
      if (tid == 0) {
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                bar_s),
            "r"(bytes)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n" ::"r"(win_s),
            "l"(slot), "r"(bytes), "r"(bar_s)
            : "memory");
      }
      while (!mbar_try_wait(bar_s, (uint32_t)(i & 1))) {
      }
    } else {
      for (int k = tid * 4; k < n; k += kThreads * 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         win_s + (uint32_t)k * 4),
                     "l"(slot + k)
                     : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }
    // -- add 1, write the chunk out, and (cp_async) back to the ring
    for (int k = tid; k < n; k += kThreads) {
      const float v = win[k] + 1.f;
      const int tt = k / R, r = k - tt * R;
      out[(((size_t)i * chunk + tt) * B + row) * R + r] = v;
      if constexpr (V == kTma)
        win[k] = v;
      else
        slot[k] = v;
    }
    // -- the window back
    if constexpr (V == kTma) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                "l"(slot),
            "r"(win_s), "r"(bytes)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      }
    }
    __syncthreads();
  }
}

template <int V>
cudaError_t start(float* ring, float* out, int B, int chunk, int R, int per,
                  int n_chunks, size_t smem_bytes, cudaStream_t stream) {
  const auto kernel = ring_probe_kernel<V>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (e != cudaSuccess) return e;
  if (B == 0 || n_chunks == 0) return cudaSuccess;
  kernel<<<B, kThreads, smem_bytes, stream>>>(ring, out, B, chunk, R, per,
                                              n_chunks);
  return cudaGetLastError();
}


// -- the pipelined kernel (ring_pipe_kernel)

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// A wait that outlasts kWaitTrapNs (a lost arrival, a miscounted phase:
// the whole launch takes well under a millisecond) traps, so that such a
// fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > kWaitTrapNs) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's newest bulk groups are pending:
// complete (written to global memory), or with kRead only done reading
// their shared-memory source.
template <int N, bool kRead>
__device__ __forceinline__ void bulk_wait_n() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// bulk_wait_n for a count known at run time; a count past 7 waits for 7,
// which waits for more groups than asked, never fewer.
template <bool kRead>
__device__ __forceinline__ void bulk_wait(int n) {
  switch (n) {
    case 0: bulk_wait_n<0, kRead>(); break;
    case 1: bulk_wait_n<1, kRead>(); break;
    case 2: bulk_wait_n<2, kRead>(); break;
    case 3: bulk_wait_n<3, kRead>(); break;
    case 4: bulk_wait_n<4, kRead>(); break;
    case 5: bulk_wait_n<5, kRead>(); break;
    case 6: bulk_wait_n<6, kRead>(); break;
    default: bulk_wait_n<7, kRead>(); break;
  }
}

// Block b = row * blocks_per_row + piece owns t rows [piece * rows_per_block,
// + nt) of row `row`'s window in every chunk. The producer's bulk groups
// are committed two per chunk, the write-back then the output, so when the
// load of chunk j = i + L is issued (chunk i's groups not yet committed),
// chunk j - per's write-back has 1 + 2 (per - L - 1) newer groups and the
// output stores of chunk j - stages, the stage's last reader, 2 (stages -
// L - 1).
template <int C>
__global__ void __launch_bounds__(kPipeThreads)
ring_pipe_kernel(float* ring, float* out, int B, int chunk, int R, int per,
                 int n_chunks, int rows_per_block, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], ready[kMaxStages];
  const int blocks_per_row = (chunk + rows_per_block - 1) / rows_per_block;
  const int row = blockIdx.x / blocks_per_row;
  const int t0 = (blockIdx.x % blocks_per_row) * rows_per_block;
  const int nt = min(rows_per_block, chunk - t0);
  const int n = nt * R;                                  // piece elements
  const uint32_t bytes = (uint32_t)n * sizeof(float);
  const uint32_t run = (uint32_t)R * sizeof(float);      // one t row
  const uint32_t stage_bytes = (uint32_t)rows_per_block * run;
  const int S = stages, L = min(stages - 1, per - 1);
  const size_t slot_stride = (size_t)chunk * R;
  float* ring_piece = ring + ((size_t)row * per * chunk + t0) * R;
  const uint32_t stage0 = smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), C == kBulkCopy ? 1 : 32);
      mbar_init(smem_u32(&ready[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // -- the producer
    if (C == kBulkCopy && lane != 0) return;
    auto load = [&](int j) {
      const float* src = ring_piece + (size_t)(j % per) * slot_stride;
      const uint32_t dst = stage0 + (uint32_t)(j % S) * stage_bytes;
      const uint32_t bar = smem_u32(&full[j % S]);
      if constexpr (C == kBulkCopy) {
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                bar),
            "r"(bytes)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
            "l"(src), "r"(bytes), "r"(bar)
            : "memory");
      } else {
        for (int k = lane * 4; k < n; k += 32 * 4)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           dst + (uint32_t)k * 4),
                       "l"(src + k)
                       : "memory");
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     ::"r"(bar)
                     : "memory");
      }
    };
    for (int j = 0; j < L && j < n_chunks; ++j) load(j);
    for (int i = 0; i < n_chunks; ++i) {
      const int j = i + L;
      if (j < n_chunks) {
        // cp_async_pipe: chunk j - per's stores and chunk j - S's reads of
        // the stage are behind the `ready` waits of earlier iterations
        if constexpr (C == kBulkCopy) {
          if (j >= per) bulk_wait<false>(1 + 2 * (per - L - 1));
          if (j >= S) bulk_wait<true>(2 * (S - L - 1));
        }
        load(j);
      }
      const int s = i % S;
      mbar_wait(smem_u32(&ready[s]), (uint32_t)((i / S) & 1));
      if constexpr (C == kBulkCopy) {
        const uint32_t src = stage0 + (uint32_t)s * stage_bytes;
        bulk_store(ring_piece + (size_t)(i % per) * slot_stride, src, bytes);
        bulk_commit();
        float* o = out + (((size_t)i * chunk + t0) * B + row) * R;
        for (int t = 0; t < nt; ++t)
          bulk_store(o + (size_t)t * B * R, src + (uint32_t)t * run, run);
        bulk_commit();
      }
    }
    // the stages must outlive the stores that read them
    if constexpr (C == kBulkCopy) bulk_wait_n<0, false>();
    return;
  }

  // -- the consumers: +1 over the piece, float4 by float4
  const int r4 = R / 4;
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % S;
    mbar_wait(smem_u32(&full[s]), (uint32_t)((i / S) & 1));
    float4* win = reinterpret_cast<float4*>(smem + (size_t)s * stage_bytes);
    if constexpr (C == kBulkCopy) {
      for (int k = threadIdx.x; k < n / 4; k += kConsumerWarps * 32) {
        float4 v = win[k];
        v.x += 1.f, v.y += 1.f, v.z += 1.f, v.w += 1.f;
        win[k] = v;
      }
      // the +1 (generic proxy) before the producer's bulk copies read it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    } else {
      float4* slot = reinterpret_cast<float4*>(
          ring_piece + (size_t)(i % per) * slot_stride);
      float* o = out + (((size_t)i * chunk + t0) * B + row) * R;
      for (int k = threadIdx.x; k < n / 4; k += kConsumerWarps * 32) {
        float4 v = win[k];
        v.x += 1.f, v.y += 1.f, v.z += 1.f, v.w += 1.f;
        slot[k] = v;
        const int t = k / r4;
        reinterpret_cast<float4*>(o + (size_t)t * B * R)[k - t * r4] = v;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&ready[s]));
  }
}

template <int C>
cudaError_t start_pipe(float* ring, float* out, int B, int chunk, int R,
                       int per, int n_chunks, int rows_per_block, int stages,
                       size_t smem_bytes, cudaStream_t stream) {
  const auto kernel = ring_pipe_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (e != cudaSuccess) return e;
  if (B == 0 || n_chunks == 0) return cudaSuccess;
  const int blocks_per_row = (chunk + rows_per_block - 1) / rows_per_block;
  kernel<<<B * blocks_per_row, kPipeThreads, smem_bytes, stream>>>(
      ring, out, B, chunk, R, per, n_chunks, rows_per_block, stages);
  return cudaGetLastError();
}

// The current device's SM count and shared memory per block (opt-in).
cudaError_t device_limits(int* sms, int* smem_max) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e;
}

}  // namespace

// Launch on `stream` on the current device: `ring` is a zeroed (B, per *
// chunk, R) fp32 buffer, `out` (n_chunks * chunk, B, R) fp32; variant 0 is
// the bulk copy (TMA) with an mbarrier, 1 is cp.async. Returns 0, one of
// the kErr* refusals (checked before anything runs: a shape the copies
// cannot take, an unknown variant, a window larger than a block's shared
// memory), or the cudaError_t of the attribute call or the launch.
extern "C" int ring_probe(float* ring, float* out, int B, int chunk, int R,
                          int per, int n_chunks, int variant, void* stream) {
  if (B < 0 || chunk < 1 || per < 1 || n_chunks < 0 || R < 4 || R % 4 != 0)
    return kErrShape;
  if (variant != kTma && variant != kCpAsync) return kErrVariant;
  const size_t smem_bytes = (size_t)chunk * R * sizeof(float);
  int sms = 0, smem_max = 0;
  const cudaError_t e = device_limits(&sms, &smem_max);
  if (e != cudaSuccess) return (int)e;
  // the static mbarrier takes 8 bytes beside the window
  if (smem_bytes + 8 > (size_t)smem_max) return kErrSharedMemory;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(variant == kTma
                   ? start<kTma>(ring, out, B, chunk, R, per, n_chunks,
                                 smem_bytes, s)
                   : start<kCpAsync>(ring, out, B, chunk, R, per, n_chunks,
                                     smem_bytes, s));
}

// The pipelined variants: `copy` 0 is tma_pipe (bulk copies in, back and
// out), 1 is cp_async_pipe (cp.async in, plain stores back and out); each
// row's window split into pieces of `rows_per_block` t rows, one block
// each, pipelined through `stages` stages of rows_per_block * R fp32
// (ops/ring_probe.py `split`). Same buffers and returns as `ring_probe`;
// kErrSplit refuses a split the kernel cannot take.
extern "C" int ring_probe_pipe(float* ring, float* out, int B, int chunk,
                               int R, int per, int n_chunks, int copy,
                               int rows_per_block, int stages,
                               void* stream) {
  if (B < 0 || chunk < 1 || per < 1 || n_chunks < 0 || R < 4 || R % 4 != 0)
    return kErrShape;
  if (copy != kBulkCopy && copy != kCpAsyncCopy) return kErrVariant;
  if (rows_per_block < 1 || rows_per_block > chunk || stages < 1 ||
      stages > kMaxStages ||
      (long long)B * ((chunk + rows_per_block - 1) / rows_per_block) >
          0x7fffffffLL)
    return kErrSplit;
  const size_t smem_bytes =
      (size_t)stages * rows_per_block * R * sizeof(float);
  int sms = 0, smem_max = 0;
  const cudaError_t e = device_limits(&sms, &smem_max);
  if (e != cudaSuccess) return (int)e;
  if (smem_bytes + 2 * kMaxStages * sizeof(uint64_t) > (size_t)smem_max)
    return kErrSharedMemory;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(copy == kBulkCopy
                   ? start_pipe<kBulkCopy>(ring, out, B, chunk, R, per,
                                           n_chunks, rows_per_block, stages,
                                           smem_bytes, s)
                   : start_pipe<kCpAsyncCopy>(ring, out, B, chunk, R, per,
                                              n_chunks, rows_per_block,
                                              stages, smem_bytes, s));
}

// The current device's SM count and a block's shared memory (opt-in), the
// inputs of the pipelined variants' split. Returns 0 or a cudaError_t.
extern "C" int ring_probe_limits(int* sms, int* smem_max) {
  return (int)device_limits(sms, smem_max);
}

extern "C" const char* ring_probe_error_string(int e) {
  switch (e) {
    case kErrShape:
      return "ring probe shape: chunk, per >= 1, n_chunks >= 0 and R a "
             "positive multiple of 4 (16-byte copies)";
    case kErrVariant:
      return "unknown variant (ring_probe 0: tma, 1: cp_async; "
             "ring_probe_pipe 0: tma_pipe, 1: cp_async_pipe)";
    case kErrSplit:
      return "ring probe split: 1 <= rows_per_block <= chunk, 1 <= stages "
             "<= 8 and at most 2^31 - 1 blocks";
    case kErrSharedMemory:
      return "shared memory: a (chunk, R) fp32 window, or the pipelined "
             "variants' stages, exceed a block's shared memory";
  }
  return cudaGetErrorString((cudaError_t)e);
}
