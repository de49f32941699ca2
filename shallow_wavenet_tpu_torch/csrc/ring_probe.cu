// Ring-window copy probe on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kernel` launched by `main` in
// tools/dma_probe.py. That probe checked, before the streamed-ring AR
// kernel depended on it, that a ring held in device memory persists
// across the steps of a sequential grid and that a window of it can be
// copied in and out by asynchronous copies with a completion wait. This
// kernel checks the Hopper forms of the same mechanism: asynchronous
// global -> shared copies of ring windows that persist across chunks, with
// a completion barrier.
//
// What it computes: a ring of `per` windows of (chunk, R) fp32 per batch
// row, zeroed by the caller. Chunk i copies window i mod per in, adds 1,
// writes it to chunk i of the output and copies it back. So every value of
// output chunk i is i // per + 1 (the TPU probe's check), and a stale
// window, a copy that has not landed, or a write-back that a later load
// does not see shows up as a wrong chunk value, not as a crash.
//
// Layout: one block per batch row loops over the chunks (the TPU probe's
// sequential grid), the row's window in shared memory. The TPU probe's
// window (64, 8, 128) fp32 is 256 KB, more than a block's 227 KB, so it is
// split by row, as the AR kernel splits its rings by row. The ring is
// (B, per * chunk, R), so a row's window is one contiguous run of
// chunk * R * 4 bytes; the output keeps the TPU probe's (n_chunks * chunk,
// B, R) layout.
//
// Two variants of the copy (template parameter V):
//   kTma      one thread issues a bulk copy (cp.async.bulk, the TMA's
//             non-tensor form) of the whole window global -> shared that
//             completes on an mbarrier whose expected byte count is the
//             window's; all threads wait on the barrier's phase. After the
//             +1 (generic-proxy stores into the window), every thread
//             fences the async proxy (fence.proxy.async.shared::cta) and,
//             past a block barrier, one thread issues the bulk copy shared
//             -> global and waits for it to complete
//             (cp.async.bulk.wait_group 0) before the window is reused and
//             before a later chunk loads that slot: the TPU probe's
//             make_async_copy + DMA semaphore, start and wait.
//   kCpAsync  every thread issues 16-byte cp.async.cg copies of its part of
//             the window, then cp.async.wait_group 0 and a block barrier;
//             the write-back is plain stores.
//
// What bounds it: bytes. Each chunk moves three windows per row (in, out,
// back), and nothing overlaps: a chunk's copy-in waits for the previous
// chunk's write-back, as in the TPU probe, so a chunk costs about one
// round trip to device memory per copy, not a share of 3.35 TB/s. Timing
// it says what a window copy costs on this card; overlapping them (double
// buffering) is the AR kernel's later design, not this probe's.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kErrShape = -1, kErrVariant = -2, kErrSharedMemory = -3;
enum Variant : int { kTma = 0, kCpAsync = 1 };

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
  int device = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
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

extern "C" const char* ring_probe_error_string(int e) {
  switch (e) {
    case kErrShape:
      return "ring probe shape: chunk, per >= 1, n_chunks >= 0 and R a "
             "positive multiple of 4 (16-byte copies)";
    case kErrVariant:
      return "unknown variant (0: tma, 1: cp_async)";
    case kErrSharedMemory:
      return "shared memory: a (chunk, R) fp32 window exceeds a block's "
             "shared memory";
  }
  return cudaGetErrorString((cudaError_t)e);
}
