// Ablation probe of the unfused AR step on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel built by `build` and launched by `run` in
// tools/kprobe.py. That tool times the unfused AR step with one part
// stripped out at a time, to say where a step's time goes; each ablation
// is a well-defined function, but only `full` (and the schedule variants
// below) computes the vocoder's. Here each ablation is a template flag on
// one body, and that body is the production kernel's unfused resident
// body (csrc/ar_generate.cu, `ar_generate_kernel<W, false>`), stage for
// stage, barrier for barrier and in the same summation order, with the
// probe's simplifications: the Laplace head, unit input weights and no
// biases (the TPU probe has none). So `full` equals `ar_generate` to the
// bit on weights with unit input weights and zero biases, and an
// ablation's saving applies to the production step.
//
// What it computes, per output sample t and batch row (fp32 or bf16
// storage W, as in ar_generate.cu: `rnd` rounds to W where the TPU kernel
// calls `.astype(wdt)`):
//   h = rnd(rnd(x[t-1]) + in_b)          (x[-1] = 0)
//   cc = rnd(c_t) @ V                    every layer's conditioning term
//   for every layer l:  u = ring_l[t mod d_l] @ W0 + h @ W1 + cc_l
//                       z = rnd(tanh(u_a) * sigmoid(u_b));  ring_l[...] = h
//                       h = rnd(h + z @ Wr);  skip += z @ Ws
//   o = rnd(relu(rnd(relu(skip)) @ H1)) @ H2
//   x = clip(mu - exp(clip(log_b)) * sign(u - 1/2) * log1p(-2|u - 1/2|))
// and the ablations (tools/kprobe.py:41-43, in its order):
//   no_cond       cc from the first conditioning frame of each chunk only
//   no_prev       no tap-0 product: u = h @ W1 + cc_l
//   no_buf        no ring: the tap-0 product reads h
//   no_resskip    h = rnd(h + z[:R]), skip += z[:S] (needs R, S <= G/2)
//   no_head       mu = log_b = skip[0] + skip[1], unclipped
//   no_sample     x = clip(mu)
//   matmuls_only  no_cond + no_buf + no_sample
//   cheap_gate    z = rnd(u_a * u_b)
//   no_gate       z = rnd(u_a)
//   gate_bf16     tanh and the sigmoid 1 / (1 + exp(-x)) on inputs rounded
//                 to W, every op rounded to W (XLA's bf16 forms); in fp32
//                 the same function as full
// and three schedules of full's own function:
//   unroll2, unroll4  the time loop unrolled by 2 / 4
//   split2            two batch rows per block, interleaved per layer, so
//                     each weight load serves both rows (with unroll4's
//                     loop, as the TPU probe's `split2`)
//
// What bounds it on this card, and what the design does about it: as
// ar_generate.cu says, a step is a serial chain of barrier-separated
// stages, each waiting on the weight loads one SM keeps in flight from L2,
// so a step's time follows the weights one SM reads per step and the
// stages between them. The probe removes one stage's loads or arithmetic
// at a time (the flags above), or shares each load between two rows
// (split2), and changes nothing else: one launch per call, one block per
// batch row (two for split2), resident rings in shared memory, the time
// loop inside the kernel, fp32 FMA chains, `__launch_bounds__(256, 1)`.
// The TPU probe's chunk grid becomes the time loop; `chunk` only sets
// where no_cond refreshes its conditioning. No ring streaming: the TPU
// probe has none, so a config whose resident rings do not fit a block is
// refused before launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 64;
// The entry point's own refusals; cudaError_t codes are >= 0.
constexpr int kErrLayers = -1, kErrAblation = -2, kErrResSkip = -3,
              kErrBatch = -4, kErrChunk = -5, kErrSharedMemory = -6;

// tools/kprobe.py ABLATIONS, in its order.
enum Ablation : int {
  kFull, kNoCond, kNoPrev, kNoBuf, kNoResSkip, kNoHead, kNoSample,
  kMatmulsOnly, kCheapGate, kNoGate, kUnroll2, kUnroll4, kSplit2, kGateBf16,
  kNumAblations
};

template <int A>
struct Flags {
  static constexpr bool no_cond = A == kNoCond || A == kMatmulsOnly;
  static constexpr bool no_prev = A == kNoPrev;
  static constexpr bool no_buf = A == kNoBuf || A == kMatmulsOnly;
  static constexpr bool no_resskip = A == kNoResSkip;
  static constexpr bool no_head = A == kNoHead;
  static constexpr bool no_sample = A == kNoSample || A == kMatmulsOnly;
  static constexpr int rows = A == kSplit2 ? 2 : 1;  // batch rows per block
  static constexpr int unroll =
      A == kUnroll2 ? 2 : (A == kUnroll4 || A == kSplit2) ? 4 : 1;
};

// Weights are W (float or __nv_bfloat16), passed untyped and cast by the
// kernel instantiation for W.
struct Params {
  const float* cond;   // (T, B, C), the TPU probe's layout
  const float* noise;  // (T, B) uniforms in (0, 1)
  float* out;          // (T, B)
  const void* in_b;    // (R,)
  const void* conv_w;  // (L, 2, R, G); tap 0 multiplies x[t - d]
  const void* cond_w;  // (L, C, G)
  const void* res_w;   // (L, G/2, R)
  const void* skip_w;  // (L, G/2, S)
  const void* h1_w;    // (S, S)
  const void* h2_w;    // (S, 2)
  int B, T, L, R, G, S, C, chunk, ring_rows;
  float log_b_min, log_b_max;
  int dil[kMaxLayers];
  int off[kMaxLayers];  // row offset of layer l's ring
};

// One block's dynamic shared memory: `nr` rows' rings (ring_rows x R
// elements of `elem` bytes each, rounded up to 16 bytes), then `nr` rows'
// fp32 scratch at the float offsets below (ar_generate.cu's resident
// unfused layout, less its streamed-slot row and head width O = 2).
struct SmemLayout {
  size_t ring_bytes;  // one row's rings
  size_t h, c, cc, gpart, z, skip, a1, o, fb, floats;  // one row's scratch
  size_t bytes;
};

__host__ __device__ inline SmemLayout smem_layout(int ring_rows, int L, int R,
                                                  int G, int S, int C,
                                                  int elem, int nr) {
  SmemLayout m;
  m.ring_bytes = ((size_t)ring_rows * R * elem + 15) / 16 * 16;
  size_t n = 0;
  m.h = n;     n += R;                 // (R) residual stream
  m.c = n;     n += C;                 // (C) conditioning at t
  m.cc = n;    n += (size_t)L * G;     // (L, G) c_t @ V of every layer
  m.gpart = n; n += 2 * G;             // (2, G) tap products
  m.z = n;     n += G / 2;             // (G/2) gated activation
  m.skip = n;  n += S;                 // (S) skip sum
  m.a1 = n;    n += S;                 // (S) head hidden
  m.o = n;     n += 2;                 // (2) mu, log_b
  m.fb = n;    n += 1;                 // feedback sample
  m.floats = n;
  m.bytes = (size_t)nr * (m.ring_bytes + n * sizeof(float));
  return m;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename W> __device__ __forceinline__ W from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x as stored in W: the TPU kernel's `.astype(wdt)`.
template <typename W> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<W>(x));
}

struct Identity {
  __device__ float operator()(float v) const { return v; }
};
// relu, then the storage type's rounding: the head's input
template <typename W> struct ReluRound {
  __device__ float operator()(float v) const {
    return rnd<W>(v > 0.f ? v : 0.f);
  }
};

// acc[q] = f(x_q) . w[0], f(x_q) . w[ld], ... for the NR rows x_q = x + q
// * xs: one output column of a row-vector product for each row, every row
// one fp32 chain in k order (with NR = 1, ar_generate.cu's dot_col, op for
// op). Each weight load serves all NR rows.
template <int NR, typename X, typename W, typename F = Identity>
__device__ __forceinline__ void dot_cols(const X* x, size_t xs, const W* w,
                                         int k_len, int ld, float (&acc)[NR],
                                         F f = F()) {
#pragma unroll
  for (int q = 0; q < NR; ++q) acc[q] = 0.f;
#pragma unroll 32
  for (int k = 0; k < k_len; ++k) {
    const float wk = to_f(w[(size_t)k * ld]);
#pragma unroll
    for (int q = 0; q < NR; ++q)
      acc[q] = fmaf(f(to_f(x[q * xs + k])), wk, acc[q]);
  }
}

// One tap product: h . w when from_h (tap 1, or tap 0 under no_buf), else
// x[t - d] . w. In fp32 both operands are float in shared memory, so one
// loop reads through a selected pointer, as ar_generate.cu's tap_dot.
template <int NR, typename W>
__device__ __forceinline__ void tap_dots(bool from_h, const float* h,
                                         size_t hs, const W* prev, size_t ps,
                                         const W* w, int R, int G,
                                         float (&acc)[NR]) {
  if (from_h)
    dot_cols<NR>(h, hs, w, R, G, acc);
  else
    dot_cols<NR>(prev, ps, w, R, G, acc);
}
template <int NR>
__device__ __forceinline__ void tap_dots(bool from_h, const float* h,
                                         size_t hs, const float* prev,
                                         size_t ps, const float* w, int R,
                                         int G, float (&acc)[NR]) {
  dot_cols<NR>(from_h ? h : prev, from_h ? hs : ps, w, R, G, acc);
}

// z from the gate inputs, by ablation.
template <typename W, int A>
__device__ __forceinline__ float gate(float ua, float ub) {
  if constexpr (A == kNoGate) {
    return rnd<W>(ua);
  } else if constexpr (A == kCheapGate) {
    return rnd<W>(ua * ub);
  } else if constexpr (A == kGateBf16) {
    const float th = rnd<W>(tanhf(rnd<W>(ua)));
    const float sg =
        rnd<W>(1.f / rnd<W>(1.f + rnd<W>(expf(-rnd<W>(ub)))));
    return rnd<W>(th * sg);
  } else {
    return rnd<W>(tanhf(ua) * (1.f / (1.f + expf(-ub))));
  }
}

__device__ __forceinline__ size_t ring_row(int off, int d, int t) {
  return (size_t)off + (t & (d - 1));
}

// As ar_generate_kernel: one block per SM is the design, and saying so
// lets ptxas spend registers on weight loads in flight.
template <typename W, int A>
__global__ void __launch_bounds__(kThreads, 1)
ar_probe_kernel(const __grid_constant__ Params p) {
  using F = Flags<A>;
  constexpr int NR = F::rows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * NR;
  const int tid = threadIdx.x;
  const int R = p.R, G = p.G, S = p.S, C = p.C, L = p.L, B = p.B;
  const int half = G / 2;
  const W* in_b = static_cast<const W*>(p.in_b);
  const W* conv_w = static_cast<const W*>(p.conv_w);
  const W* cond_w = static_cast<const W*>(p.cond_w);
  const W* res_w = static_cast<const W*>(p.res_w);
  const W* skip_w = static_cast<const W*>(p.skip_w);
  const W* h1_w = static_cast<const W*>(p.h1_w);
  const W* h2_w = static_cast<const W*>(p.h2_w);

  // row q's rings start at ring + q * rs, its scratch vectors at v + q * fs
  const SmemLayout m =
      smem_layout(p.ring_rows, L, R, G, S, C, sizeof(W), NR);
  W* ring = reinterpret_cast<W*>(smem);
  const size_t rs = m.ring_bytes / sizeof(W);
  float* f = reinterpret_cast<float*>(smem + NR * m.ring_bytes);
  const size_t fs = m.floats;
  float* h = f + m.h;
  float* c = f + m.c;
  float* cc = f + m.cc;
  float* gpart = f + m.gpart;
  float* z = f + m.z;
  float* skip = f + m.skip;
  float* a1 = f + m.a1;
  float* o = f + m.o;
  float* fb = f + m.fb;

  for (size_t i = tid; i < NR * rs; i += kThreads) ring[i] = from_f<W>(0.f);
  if (tid < NR) fb[tid * fs] = 0.f;
  __syncthreads();

  auto step = [&](int t) {
    // -- input encode, conditioning frame, zero skip
    for (int i = tid; i < NR * R; i += kThreads) {
      const int q = i / R, r = i - q * R;
      h[q * fs + r] =
          rnd<W>(__fadd_rn(rnd<W>(fb[q * fs]), to_f(in_b[r])));
    }
    const bool cond_now = !F::no_cond || t % p.chunk == 0;
    if (cond_now)
      for (int i = tid; i < NR * C; i += kThreads) {
        const int q = i / C, k = i - q * C;
        c[q * fs + k] = rnd<W>(p.cond[((size_t)t * B + row0 + q) * C + k]);
      }
    for (int i = tid; i < NR * S; i += kThreads) {
      const int q = i / S, s = i - q * S;
      skip[q * fs + s] = 0.f;
    }
    __syncthreads();
    // -- conditioning term of every layer
    if (cond_now)
      for (int i = tid; i < L * G; i += kThreads) {
        const int l = i / G, g = i - l * G;
        float acc[NR];
        dot_cols<NR>(c, fs, cond_w + (size_t)l * C * G + g, C, G, acc);
#pragma unroll
        for (int q = 0; q < NR; ++q) cc[q * fs + i] = acc[q];
      }
    __syncthreads();
    // -- residual layers
    for (int l = 0; l < L; ++l) {
      const size_t slot = ring_row(p.off[l], p.dil[l], t) * R;
      const W* w_l = conv_w + (size_t)l * 2 * R * G;
      for (int i = (F::no_prev ? G : 0) + tid; i < 2 * G; i += kThreads) {
        const int tap = i / G, g = i - tap * G;
        float acc[NR];
        tap_dots<NR>(tap || F::no_buf, h, fs, ring + slot, rs,
                     w_l + (size_t)tap * R * G + g, R, G, acc);
#pragma unroll
        for (int q = 0; q < NR; ++q) gpart[q * fs + i] = acc[q];
      }
      __syncthreads();
      for (int i = tid; i < NR * half; i += kThreads) {
        const int q = i / half, j = i - q * half, jb = half + j;
        const float* gp = gpart + q * fs;
        const float* ccl = cc + q * fs + (size_t)l * G;
        const float ua = F::no_prev ? gp[G + j] + ccl[j]
                                    : (gp[j] + gp[G + j]) + ccl[j];
        const float ub = F::no_prev ? gp[G + jb] + ccl[jb]
                                    : (gp[jb] + gp[G + jb]) + ccl[jb];
        z[q * fs + j] = gate<W, A>(ua, ub);
      }
      __syncthreads();
      // skip|res projection; the ring keeps the layer's INPUT h
      for (int n = tid; n < S + R; n += kThreads) {
        float acc[NR];
        if (n < S) {
          if constexpr (F::no_resskip) {
#pragma unroll
            for (int q = 0; q < NR; ++q) acc[q] = z[q * fs + n];
          } else {
            dot_cols<NR>(z, fs, skip_w + (size_t)l * half * S + n, half, S,
                         acc);
          }
#pragma unroll
          for (int q = 0; q < NR; ++q) skip[q * fs + n] += acc[q];
        } else {
          const int r = n - S;
          if constexpr (F::no_resskip) {
#pragma unroll
            for (int q = 0; q < NR; ++q) acc[q] = z[q * fs + r];
          } else {
            dot_cols<NR>(z, fs, res_w + (size_t)l * half * R + r, half, R,
                         acc);
          }
#pragma unroll
          for (int q = 0; q < NR; ++q) {
            if constexpr (!F::no_buf)
              ring[q * rs + slot + r] = from_f<W>(h[q * fs + r]);
            h[q * fs + r] = rnd<W>(h[q * fs + r] + acc[q]);
          }
        }
      }
      __syncthreads();
    }
    // -- head: relu -> dense -> relu -> dense
    if constexpr (!F::no_head) {
      for (int n = tid; n < S; n += kThreads) {
        float acc[NR];
        dot_cols<NR>(skip, fs, h1_w + n, S, S, acc, ReluRound<W>());
#pragma unroll
        for (int q = 0; q < NR; ++q)
          a1[q * fs + n] = rnd<W>(acc[q] > 0.f ? acc[q] : 0.f);
      }
      __syncthreads();
      for (int n = tid; n < 2; n += kThreads) {
        float acc[NR];
        dot_cols<NR>(a1, fs, h2_w + n, S, 2, acc);
#pragma unroll
        for (int q = 0; q < NR; ++q) o[q * fs + n] = acc[q];
      }
      __syncthreads();
    }
    // -- one draw per row
    if (tid < NR) {
      const int q = tid;
      const size_t tb = (size_t)t * B + row0 + q;
      float mu, lb;
      if constexpr (F::no_head) {
        mu = skip[q * fs] + skip[q * fs + 1];
        lb = mu;
      } else {
        mu = o[q * fs];
        lb = fminf(fmaxf(o[q * fs + 1], p.log_b_min), p.log_b_max);
      }
      float x = mu;
      if constexpr (!F::no_sample) {
        const float uu = p.noise[tb] - 0.5f;
        const float sg = (float)((uu > 0.f) - (uu < 0.f));
        x = __fsub_rn(mu, __fmul_rn(__fmul_rn(expf(lb), sg),
                                    log1pf(-2.f * fabsf(uu))));
      }
      x = fminf(fmaxf(x, -1.f), 1.f);
      p.out[tb] = x;
      fb[q * fs] = x;
    }
    __syncthreads();
  };

  for (int t = 0; t < p.T; t += F::unroll) {
#pragma unroll
    for (int u = 0; u < F::unroll; ++u) step(t + u);
  }
}

template <typename W, int A>
cudaError_t start(const Params& p, size_t smem_bytes, cudaStream_t stream) {
  const auto kernel = ar_probe_kernel<W, A>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (e != cudaSuccess) return e;
  if (p.B == 0 || p.T == 0) return cudaSuccess;
  kernel<<<p.B / Flags<A>::rows, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename W, int... A>
cudaError_t dispatch(int ablate, const Params& p, size_t smem_bytes,
                     cudaStream_t stream, std::integer_sequence<int, A...>) {
  cudaError_t e = cudaErrorInvalidValue;
  ((ablate == A ? (e = start<W, A>(p, smem_bytes, stream), 0) : 0), ...);
  return e;
}

int rows_per_block(int ablate) { return ablate == kSplit2 ? 2 : 1; }

}  // namespace

// Bytes of shared memory one block needs (bf16 != 0: rings in bf16), or
// kErrLayers / kErrAblation.
extern "C" long long ar_probe_smem_bytes(const int* dilations, int L, int R,
                                         int G, int S, int C, int bf16,
                                         int ablate) {
  if (L < 1 || L > kMaxLayers) return kErrLayers;
  if (ablate < 0 || ablate >= kNumAblations) return kErrAblation;
  int ring_rows = 0;
  for (int l = 0; l < L; ++l) ring_rows += dilations[l];
  return (long long)smem_layout(ring_rows, L, R, G, S, C, bf16 ? 2 : 4,
                                rows_per_block(ablate))
      .bytes;
}

// Launch ablation `ablate` (the index in tools/kprobe.py's ABLATIONS) on
// `stream` on the current device. Weights are fp32, or bf16 when bf16 !=
// 0. Returns 0, one of the kErr* refusals (checked before anything runs:
// too many layers, an unknown ablation, no_resskip with R or S > G/2,
// split2 with an odd batch, a chunk that is not a multiple of 4 dividing
// T, or a row's resident rings and scratch larger than a block's shared
// memory), or the cudaError_t of the attribute call or the launch.
extern "C" int ar_probe(const float* cond, const float* noise, float* out,
                        const void* in_b, const void* conv_w,
                        const void* cond_w, const void* res_w,
                        const void* skip_w, const void* h1_w,
                        const void* h2_w, const int* dilations, int B, int T,
                        int L, int R, int G, int S, int C, int chunk,
                        int bf16, int ablate, float log_b_min,
                        float log_b_max, void* stream) {
  const long long need =
      ar_probe_smem_bytes(dilations, L, R, G, S, C, bf16, ablate);
  if (need < 0) return (int)need;
  if (ablate == kNoResSkip && (R > G / 2 || S > G / 2)) return kErrResSkip;
  if (B % rows_per_block(ablate) != 0) return kErrBatch;
  if (chunk < 4 || chunk % 4 != 0 || T % chunk != 0) return kErrChunk;
  int device = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (e != cudaSuccess) return (int)e;
  if (need > smem_max) return kErrSharedMemory;
  Params p;
  p.cond = cond; p.noise = noise; p.out = out;
  p.in_b = in_b; p.conv_w = conv_w; p.cond_w = cond_w; p.res_w = res_w;
  p.skip_w = skip_w; p.h1_w = h1_w; p.h2_w = h2_w;
  p.B = B; p.T = T; p.L = L; p.R = R; p.G = G; p.S = S; p.C = C;
  p.chunk = chunk; p.log_b_min = log_b_min; p.log_b_max = log_b_max;
  p.ring_rows = 0;
  for (int l = 0; l < L; ++l) {
    p.dil[l] = dilations[l];
    p.off[l] = p.ring_rows;
    p.ring_rows += dilations[l];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const auto all = std::make_integer_sequence<int, kNumAblations>();
  return (int)(bf16 ? dispatch<__nv_bfloat16>(ablate, p, need, s, all)
                    : dispatch<float>(ablate, p, need, s, all));
}

extern "C" const char* ar_probe_error_string(int e) {
  switch (e) {
    case kErrLayers:
      return "more than 64 layers";
    case kErrAblation:
      return "unknown ablation";
    case kErrResSkip:
      return "no_resskip adds z[:R] and z[:S]: it needs R <= G/2 and "
             "S <= G/2";
    case kErrBatch:
      return "split2 runs two batch rows per block: it needs an even batch";
    case kErrChunk:
      return "chunk must be a positive multiple of 4 that divides T";
    case kErrSharedMemory:
      return "shared memory: one batch row's resident rings and scratch "
             "exceed a block's shared memory (the probe has no streamed "
             "rings)";
  }
  return cudaGetErrorString((cudaError_t)e);
}
