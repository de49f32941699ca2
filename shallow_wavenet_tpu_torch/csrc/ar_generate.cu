// Persistent autoregressive WaveNet generation on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel built by `_make_kernel` and launched by
// `generate_pallas` in shallow_wavenet_tpu/ops/ar_kernel.py: both heads
// (Laplace, softmax), sample and greedy modes, teacher forcing for every
// step or for a warm-up prefix; fp32 or bf16 weights and rings (`dtype`);
// every ring in shared memory, or the large-dilation ones in global memory
// (`stream`); the unfused layer loop, or the fused window (`fused` = W,
// below).
//
// What it computes, per output sample t and batch row:
//   h = encode(x[t-1])  (teacher[t] on forced steps; silence seeds t = 0)
//   for every layer l:  u = ring_l[t mod d_l] @ W0 + h @ W1 + b + c_t @ V
//                       z = tanh(u_a) * sigmoid(u_b);  ring_l[t mod d_l] = h
//                       [skip_l | res_l] = z @ [Ws | Wr] + b
//                       h += res_l;  skip += skip_l
//   o = relu(relu(skip) @ H1 + b1) @ H2 + b2, then one draw from noise[t]:
//   Laplace inverse CDF (or mu when greedy), or the softmax inverse CDF
//   (argmax when greedy). Softmax class ids are written as floats; the
//   caller dequantizes them.
//
// bf16 (the storage type W = __nv_bfloat16): weights and rings are stored
// in bf16, and h, z, the encoded input, the conditioning frame and the
// head's hidden layer are rounded to bf16 (`rnd<W>`) exactly where the TPU
// kernel calls `.astype(wdt)`. Products and sums stay fp32 in the fp32
// kernel's order (a product of two bf16 values is exact in fp32), as do
// skip, the head output and sampling. With W = float, `rnd` is the
// identity and the code is the fp32 kernel.
//
// Streamed rings: a layer the caller marks streamed keeps its ring in a
// global (B, sum of streamed dilations, R) buffer that the caller zeroes
// (so steps t < d read zeros, as the TPU kernel's `_zero`); other layers
// keep theirs in shared memory. At step t a streamed layer's slot is
// copied into a shared row (`sslot`) during the previous layer's gate
// phase, so the tap products always read shared memory, and the layer's
// input h is written back to the slot in global memory. The slot was
// written by the same block d >= 64 steps earlier, and the block barriers
// between make those global writes visible to all the block's threads.
// Storage only moves, so streamed output equals resident output bit for
// bit. (The TPU kernel copies a chunk's window of ring rows between HBM
// and VMEM; prefetching the windows with cp.async is the faster form, for
// later.)
//
// Fused window (fused = W > 0; the TPU kernel's `fused_blocks` body).
// Layers are cut into contiguous blocks of W. Within a block starting at
// layer B the residual recurrence h_m = h_B + sum_{B<=j<m} res_j is
// expanded into the gate inputs:
//   u_m = ((x_m[t-d] @ W0_m + b'_m) + c_t @ V_m)        base, at step start
//         + h_B @ W1_m                                   block input
//         + z_j @ P_{j,m}   for j = B .. m-1, in order   P = Wres_j @ W1_m
// with b'_m = b_m + sum_j res_b_j @ W1_m. Each layer's on-chain work is
// then one product, z_l @ fm_l with fm_l = [Wskip_l | Wres_l | P_{l,l+1}
// | ... | P_{l,end-1}] (the wrapper computes the products and the folded
// bias in fp32 once per call, then casts them to the storage type). Every
// contribution is summed straight into the layer's row of `cc`, so the
// fused layout needs no scratch beyond the unfused one (it drops the tap
// products and the streamed-slot row). The ring still stores the true
// layer input h, and h += res_l runs as before, so streamed rings and the
// warm-up behave as unfused. The base reads a streamed layer's slot from
// global memory through its own call site (the resident layers' reads stay
// typed for shared memory). Equal to the unfused form in exact arithmetic,
// not to the bit: the sums run in another order.
//
// What bounds it on this card. Each sample is a serial chain: two dependent
// matrix-vector products per layer plus the head, and the next sample needs
// this one. At config 2 (12 layers, R=64, G=128, S=128, C=64) a sample is
// 459,008 multiply-adds per batch row and reads 1.8 MB of fp32 weights; at
// deep_baseline (30 layers, R=128, G=256, S=256) 4.0 M multiply-adds and
// 16.0 MB (8.0 MB in bf16). The roofline of a whole call (FLOPs over
// 67 TFLOP/s, or the conditioning, noise and output bytes over 3.35 TB/s)
// is far below what the chain allows: one step cannot start before the
// previous one ends, so the time is T times the latency of one step.
//
// What the design does about it, simply and correctly first:
// - one launch for the whole (B, T) batch; the time loop runs inside the
//   kernel (the TPU kernel's sequential grid over chunks becomes this loop);
// - one thread block per batch row, so rows run in parallel on separate SMs
//   and a row's result never depends on the batch it was decoded in;
// - the row's packed dilation rings (layer l owns rows [off_l, off_l + d_l)
//   of its region, slot off_l + (t & (d_l - 1))), h, skip, z and the gate
//   inputs live in shared memory, except the streamed rings; the weights
//   are read from global memory every step and stay resident in the 50 MB
//   L2;
// - the conditioning term of all layers (c_t @ V) is computed once per step
//   across all threads, off the layer-to-layer chain;
// - fp32 FMA throughout, no tensor cores.
// A step is then bound by one SM pulling all the weights through its L2
// port in a series of dependent stages (3L + 5 block barriers per step;
// 2L + ceil(L/W) + 5 fused, with more weights: the P products), not by
// arithmetic: rows run on their own SMs, so the time per step
// hardly depends on the batch. Prefetching the next stage's weights into
// shared memory, or spreading them over the shared memory of a cluster of
// SMs so each SM streams a slice, is the later, faster design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 64;
constexpr int kMaxPerLane = 32;   // softmax classes per lane: Q <= 1024
constexpr unsigned kFull = 0xffffffffu;
// The entry points' own refusals; cudaError_t codes are >= 0.
constexpr int kErrLayers = -1, kErrClasses = -2, kErrSharedMemory = -3,
              kErrStreamRing = -4, kErrFused = -5;

// Weights are W (float or __nv_bfloat16), passed untyped and cast by the
// kernel instantiation for W.
struct Params {
  const float* c_up;     // (B, T, C)
  const float* noise;    // (B, T) uniforms in (0, 1)
  const float* teacher;  // (B, T) forced inputs, or nullptr
  float* out;            // (B, T) samples, or class ids as floats
  const void* in_w;      // (1, R) projection or (Q, R) embedding
  const void* in_b;      // (R,)
  const void* conv_w;    // (L, 2, R, G); tap 0 multiplies x[t - d]
  const void* conv_b;    // (L, G); fused: the folded bias b'
  const void* cond_w;    // (L, C, G)
  const void* res_w;     // (L, G/2, R); unfused only
  const void* res_b;     // (L, R)
  const void* skip_w;    // (L, G/2, S); unfused only
  const void* skip_b;    // (L, S)
  const void* fm;        // fused: (G/2, S + R + rem_l * G) at fm_off[l]
  const void* h1_w;      // (S, S)
  const void* h1_b;      // (S,)
  const void* h2_w;      // (S, O)
  const void* h2_b;      // (O,)
  void* strm_ring;       // (B, strm_rows, R) streamed rings, or nullptr
  int B, T, L, R, G, S, C, Q, O;
  int softmax, greedy, n_forced, res_rows, strm_rows;
  int fused;             // window W; 0: unfused
  float log_b_min, log_b_max;
  int dil[kMaxLayers];
  int off[kMaxLayers];   // row offset in the layer's region
  int strm[kMaxLayers];  // 1: ring in strm_ring, 0: in shared memory
  long long fm_off[kMaxLayers];  // fused: element offset of layer l in fm
};

// One block's dynamic shared memory: the resident rings (res_rows x R
// elements of `elem` bytes), then fp32 scratch at the float offsets below.
// The only statement of the layout, used by the kernel to carve it and by
// the host to size it. The fused form has no tap products and reads
// streamed slots in place, so it drops `gpart` and `sslot`.
struct SmemLayout {
  size_t ring_bytes;  // resident rings, rounded up to 16 bytes
  size_t h, sslot, c, cc, gpart, z, skip, a1, o, fb, floats;
  size_t bytes;       // the whole block's dynamic shared memory
};

__host__ __device__ inline SmemLayout smem_layout(int res_rows, int L, int R,
                                                  int G, int S, int C, int O,
                                                  int elem, bool fused) {
  SmemLayout m;
  m.ring_bytes = ((size_t)res_rows * R * elem + 15) / 16 * 16;
  size_t n = 0;
  m.h = n;     n += R;                  // (R) residual stream
  m.sslot = n; n += fused ? 0 : R;      // (R) a streamed slot, as W
  m.c = n;     n += C;                  // (C) conditioning at t
  m.cc = n;    n += (size_t)L * G;      // (L, G) every layer's gate input
                                        // terms (unfused: c_t @ V only)
  m.gpart = n; n += fused ? 0 : 2 * G;  // (2, G) tap products
  m.z = n;     n += G / 2;              // (G/2) gated activation
  m.skip = n;  n += S;                  // (S) skip sum
  m.a1 = n;    n += S;                  // (S) head hidden
  m.o = n;     n += O;                  // (O) head output
  m.fb = n;    n += 1;                  // feedback sample or class id
  m.floats = n;
  m.bytes = m.ring_bytes + n * sizeof(float);
  return m;
}

// Element offset of each layer's fused projection fm_l in the packed fm
// buffer (layer order; fm_l is (G/2, S + R + rem_l * G), rem_l the layers
// after l in its block of W).
void pack_fm(int L, int W, int R, int G, int S, long long* fm_off) {
  long long n = 0;
  for (int l = 0; l < L; ++l) {
    const int end = (l / W + 1) * W < L ? (l / W + 1) * W : L;
    fm_off[l] = n;
    n += (long long)(G / 2) * (S + R + (end - 1 - l) * G);
  }
}

// Packs the rings: resident layers in shared memory, streamed layers in the
// global buffer, each region in layer order. Returns the two row counts.
void pack_rings(const int* dil, const int* streamed, int L, int* off,
                int* res_rows, int* strm_rows) {
  *res_rows = 0;
  *strm_rows = 0;
  for (int l = 0; l < L; ++l) {
    int* rows = streamed[l] ? strm_rows : res_rows;
    off[l] = *rows;
    *rows += dil[l];
  }
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

// y = f(x) . w[0], f(x) . w[ld], ... : one output column of a row-vector
// product. The sum is one fp32 chain in k order; unrolling by 32 lets 32
// independent weight loads be in flight at once, which is what sets a
// stage's time (a step is a series of L2 round trips, not of arithmetic).
template <typename X, typename W, typename F = Identity>
__device__ __forceinline__ float dot_col(const X* x, const W* w, int k_len,
                                         int ld, F f = F()) {
  float acc = 0.f;
#pragma unroll 32
  for (int k = 0; k < k_len; ++k)
    acc = fmaf(f(to_f(x[k])), to_f(w[(size_t)k * ld]), acc);
  return acc;
}

// One tap product: x[t - d] . w for tap 0, h . w for tap 1.
// In fp32 both operands are float in shared memory, so one loop reads
// through a selected pointer; in bf16 the ring slot is bf16 and h fp32.
template <typename W>
__device__ __forceinline__ float tap_dot(int tap, const float* h,
                                         const W* prev, const W* w, int R,
                                         int G) {
  return tap ? dot_col(h, w, R, G) : dot_col(prev, w, R, G);
}
template <>
__device__ __forceinline__ float tap_dot<float>(int tap, const float* h,
                                                const float* prev,
                                                const float* w, int R,
                                                int G) {
  return dot_col(tap ? h : prev, w, R, G);
}

// The ring row a layer reads and writes at step t.
__device__ __forceinline__ size_t ring_row(int off, int d, int t) {
  return (size_t)off + (t & (d - 1));
}

// Copies a streamed ring slot from global into shared memory, so that the
// tap products always read shared memory.
template <typename W>
__device__ __forceinline__ void copy_slot(W* dst, const W* src, int R,
                                          int tid) {
  for (int r = tid; r < R; r += kThreads) dst[r] = src[r];
}

// One softmax draw by warp 0: id = clip(#{q : cdf(q) < u}, 0, Q-1), or the
// first argmax when greedy. Lane l holds classes [l*per, (l+1)*per).
__device__ int sample_class(const float* o, int Q, float u, bool greedy,
                            int lane) {
  const int per = Q / 32;
  float v[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i)
    v[i] = i < per ? o[lane * per + i] : -INFINITY;
  if (greedy) {
    float best = v[0];
    int bi = lane * per;
#pragma unroll
    for (int i = 1; i < kMaxPerLane; ++i)
      if (i < per && v[i] > best) { best = v[i]; bi = lane * per + i; }
    for (int s = 16; s > 0; s >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, s);
      const int oi = __shfl_xor_sync(kFull, bi, s);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    return bi;
  }
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) if (i < per) m = fmaxf(m, v[i]);
  for (int s = 16; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, s));
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i)
    if (i < per) { v[i] = expf(v[i] - m); tot += v[i]; }
  for (int s = 16; s > 0; s >>= 1) tot += __shfl_xor_sync(kFull, tot, s);
  // probabilities, then this lane's running sum
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i)
    if (i < per) { run += v[i] / tot; v[i] = run; }
  // inclusive scan of the lane sums; the exclusive part offsets this lane
  float incl = run;
  for (int s = 1; s < 32; s <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, s);
    if (lane >= s) incl += y;
  }
  float base = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) base = 0.f;
  int n = 0;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i)
    if (i < per && base + v[i] < u) ++n;
  for (int s = 16; s > 0; s >>= 1) n += __shfl_xor_sync(kFull, n, s);
  return min(max(n, 0), Q - 1);
}

// One block per SM is the design (rows on their own SMs), and saying so
// (min 1 block) lets ptxas spend registers on weight loads in flight;
// without it ptxas capped this kernel at 80 registers and interleaved the
// unrolled loads with their FMAs, which slowed every step.
template <typename W, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
ar_generate_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int R = p.R, G = p.G, S = p.S, C = p.C, L = p.L, O = p.O;
  const int half = G / 2;
  const W* in_w = static_cast<const W*>(p.in_w);
  const W* in_b = static_cast<const W*>(p.in_b);
  const W* conv_w = static_cast<const W*>(p.conv_w);
  const W* conv_b = static_cast<const W*>(p.conv_b);
  const W* cond_w = static_cast<const W*>(p.cond_w);
  const W* res_w = static_cast<const W*>(p.res_w);
  const W* res_b = static_cast<const W*>(p.res_b);
  const W* skip_w = static_cast<const W*>(p.skip_w);
  const W* skip_b = static_cast<const W*>(p.skip_b);
  const W* h1_w = static_cast<const W*>(p.h1_w);
  const W* h1_b = static_cast<const W*>(p.h1_b);
  const W* h2_w = static_cast<const W*>(p.h2_w);
  const W* h2_b = static_cast<const W*>(p.h2_b);
  const W* fm = static_cast<const W*>(p.fm);
  W* strm_ring = p.strm_rows
      ? static_cast<W*>(p.strm_ring) + (size_t)row * p.strm_rows * R
      : nullptr;

  const SmemLayout m =
      smem_layout(p.res_rows, L, R, G, S, C, O, sizeof(W), kFused);
  W* ring = reinterpret_cast<W*>(smem);
  float* f = reinterpret_cast<float*>(smem + m.ring_bytes);
  float* h = f + m.h;
  W* sslot = reinterpret_cast<W*>(f + m.sslot);
  float* c = f + m.c;
  float* cc = f + m.cc;
  float* gpart = f + m.gpart;
  float* z = f + m.z;
  float* skip = f + m.skip;
  float* a1 = f + m.a1;
  float* o = f + m.o;
  float* fb = f + m.fb;

  for (int i = tid; i < p.res_rows * R; i += kThreads) ring[i] = from_f<W>(0.f);
  if (tid == 0) fb[0] = p.softmax ? (float)(p.Q / 2) : 0.f;  // silence
  __syncthreads();

  const float* c_row = p.c_up + (size_t)row * p.T * C;
  for (int t = 0; t < p.T; ++t) {
    const size_t bt = (size_t)row * p.T + t;
    // -- input encode, conditioning frame, zero skip
    const float x_in = t < p.n_forced ? p.teacher[bt] : fb[0];
    if (p.softmax) {
      const int id = (int)x_in;
      const bool ok = id >= 0 && id < p.Q;   // one-hot of an out-of-range id is 0
      for (int r = tid; r < R; r += kThreads)
        h[r] = ok ? to_f(in_w[(size_t)id * R + r]) : 0.f;
    } else {
      const float xw = rnd<W>(x_in);
      for (int r = tid; r < R; r += kThreads)
        h[r] = rnd<W>(__fadd_rn(rnd<W>(__fmul_rn(xw, to_f(in_w[r]))),
                                to_f(in_b[r])));
    }
    for (int k = tid; k < C; k += kThreads)
      c[k] = rnd<W>(c_row[(size_t)t * C + k]);
    for (int s = tid; s < S; s += kThreads) skip[s] = 0.f;
    __syncthreads();
    if constexpr (kFused) {
      // -- every layer's base: tap 0 on x[t - d], folded bias, conditioning
      for (int i = tid; i < L * G; i += kThreads) {
        const int l = i / G, g = i - l * G;
        const W* w0 = conv_w + (size_t)l * 2 * R * G + g;
        const size_t slot = ring_row(p.off[l], p.dil[l], t) * R;
        const float a = p.strm[l] ? dot_col(strm_ring + slot, w0, R, G)
                                  : dot_col(ring + slot, w0, R, G);
        cc[i] = (a + to_f(conv_b[i]))
                + dot_col(c, cond_w + (size_t)l * C * G + g, C, G);
      }
      __syncthreads();
      for (int b0 = 0; b0 < L; b0 += p.fused) {
        const int end = min(b0 + p.fused, L);
        // -- block input: h_B @ W1 of every layer of the block
        for (int i = tid; i < (end - b0) * G; i += kThreads) {
          const int l = b0 + i / G, g = i % G;
          cc[(size_t)l * G + g] +=
              dot_col(h, conv_w + ((size_t)l * 2 + 1) * R * G + g, R, G);
        }
        __syncthreads();
        for (int l = b0; l < end; ++l) {
          const float* ccl = cc + (size_t)l * G;
          for (int j = tid; j < half; j += kThreads)
            z[j] = rnd<W>(tanhf(ccl[j])
                          * (1.f / (1.f + expf(-ccl[half + j]))));
          __syncthreads();
          // z @ [skip | res | P toward each later layer of the block]; the
          // ring keeps the layer's INPUT h
          const int ld = S + R + (end - 1 - l) * G;
          const W* fml = fm + p.fm_off[l];
          const size_t slot_row = ring_row(p.off[l], p.dil[l], t);
          for (int n = tid; n < ld; n += kThreads) {
            const float acc = dot_col(z, fml + n, half, ld);
            if (n < S) {
              skip[n] += acc + to_f(skip_b[(size_t)l * S + n]);
            } else if (n < S + R) {
              const int r = n - S;
              const float res = acc + to_f(res_b[(size_t)l * R + r]);
              if (p.strm[l])
                strm_ring[slot_row * R + r] = from_f<W>(h[r]);
              else
                ring[slot_row * R + r] = from_f<W>(h[r]);
              h[r] = rnd<W>(h[r] + res);
            } else {
              cc[(size_t)(l + 1) * G + (n - S - R)] += acc;
            }
          }
          __syncthreads();
        }
      }
    } else {
      // -- conditioning term of every layer
      for (int i = tid; i < L * G; i += kThreads) {
        const int l = i / G, g = i - l * G;
        cc[i] = dot_col(c, cond_w + (size_t)l * C * G + g, C, G);
      }
      if (p.strm[0])
        copy_slot(sslot, strm_ring + ring_row(p.off[0], p.dil[0], t) * R,
                  R, tid);
      __syncthreads();
      // -- residual layers
      for (int l = 0; l < L; ++l) {
        const bool strm = p.strm[l] != 0;
        const size_t slot_row = ring_row(p.off[l], p.dil[l], t);
        W* rslot = ring + slot_row * R;
        const W* prev = strm ? sslot : rslot;  // x[t - d], in shared memory
        const W* w_l = conv_w + (size_t)l * 2 * R * G;
        for (int i = tid; i < 2 * G; i += kThreads) {
          const int tap = i / G, g = i - tap * G;
          gpart[i] =
              tap_dot(tap, h, prev, w_l + (size_t)tap * R * G + g, R, G);
        }
        __syncthreads();
        const W* b = conv_b + (size_t)l * G;
        const float* ccl = cc + (size_t)l * G;
        for (int j = tid; j < half; j += kThreads) {
          const float ua =
              ((gpart[j] + gpart[G + j]) + to_f(b[j])) + ccl[j];
          const int jb = half + j;
          const float ub =
              ((gpart[jb] + gpart[G + jb]) + to_f(b[jb])) + ccl[jb];
          z[j] = rnd<W>(tanhf(ua) * (1.f / (1.f + expf(-ub))));
        }
        // sslot is free until the next layer's tap products
        if (l + 1 < L && p.strm[l + 1])
          copy_slot(sslot,
                    strm_ring + ring_row(p.off[l + 1], p.dil[l + 1], t) * R,
                    R, tid);
        __syncthreads();
        // skip|res projection; the ring keeps the layer's INPUT h
        for (int n = tid; n < S + R; n += kThreads) {
          if (n < S) {
            skip[n] +=
                dot_col(z, skip_w + (size_t)l * half * S + n, half, S)
                + to_f(skip_b[(size_t)l * S + n]);
          } else {
            const int r = n - S;
            const float res =
                dot_col(z, res_w + (size_t)l * half * R + r, half, R)
                + to_f(res_b[(size_t)l * R + r]);
            if (strm)
              strm_ring[slot_row * R + r] = from_f<W>(h[r]);
            else
              rslot[r] = from_f<W>(h[r]);
            h[r] = rnd<W>(h[r] + res);
          }
        }
        __syncthreads();
      }
    }
    // -- head: relu -> dense -> relu -> dense
    for (int n = tid; n < S; n += kThreads) {
      const float acc =
          dot_col(skip, h1_w + n, S, S, ReluRound<W>()) + to_f(h1_b[n]);
      a1[n] = rnd<W>(acc > 0.f ? acc : 0.f);
    }
    __syncthreads();
    for (int n = tid; n < O; n += kThreads)
      o[n] = dot_col(a1, h2_w + n, S, O) + to_f(h2_b[n]);
    __syncthreads();
    // -- one draw per row, by warp 0
    if (tid < 32) {
      const float u = p.noise[bt];
      float x = 0.f;
      if (p.softmax) {
        x = (float)sample_class(o, p.Q, u, p.greedy != 0, tid);
      } else if (tid == 0) {
        const float mu = o[0];
        const float lb = fminf(fmaxf(o[1], p.log_b_min), p.log_b_max);
        x = mu;
        if (!p.greedy) {
          const float uu = u - 0.5f;
          const float sg = (float)((uu > 0.f) - (uu < 0.f));
          x = __fsub_rn(mu, __fmul_rn(__fmul_rn(expf(lb), sg),
                                      log1pf(-2.f * fabsf(uu))));
        }
        x = fminf(fmaxf(x, -1.f), 1.f);
      }
      if (tid == 0) {
        p.out[bt] = x;
        fb[0] = x;
      }
    }
    __syncthreads();
  }
}

template <typename W>
cudaError_t start(const Params& p, size_t smem_bytes, cudaStream_t stream) {
  const auto kernel = p.fused ? ar_generate_kernel<W, true>
                              : ar_generate_kernel<W, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (e != cudaSuccess) return e;
  if (p.B == 0 || p.T == 0) return cudaSuccess;
  kernel<<<p.B, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The device's shared memory per block (opt-in maximum) on the current
// device, into *bytes. Returns the cudaError_t.
extern "C" int ar_smem_limit(int* bytes) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  return (int)e;
}

// Bytes of shared memory one block needs for this layout: streamed[l] != 0
// puts layer l's ring in global memory; bf16 != 0 stores rings in bf16;
// fused > 0 is the fused window's layout. Returns kErrLayers on a layer
// count the kernel cannot take.
extern "C" long long ar_smem_bytes(const int* dilations, const int* streamed,
                                   int L, int R, int G, int S, int C, int O,
                                   int bf16, int fused) {
  if (L < 1 || L > kMaxLayers) return kErrLayers;
  int off[kMaxLayers], res_rows, strm_rows;
  pack_rings(dilations, streamed, L, off, &res_rows, &strm_rows);
  return (long long)smem_layout(res_rows, L, R, G, S, C, O, bf16 ? 2 : 4,
                                fused > 0)
      .bytes;
}

// Launch on `stream` on the current device. Weights are fp32, or bf16 when
// bf16 != 0; strm_ring is a zeroed (B, sum of streamed dilations, R)
// buffer of the same type when any layer is streamed. fused = W > 0 runs
// the fused window: conv_b is then the folded bias and fm the layers'
// fused projections packed in layer order (see pack_fm); res_w and skip_w
// are not read. Returns 0, one of the kErr* refusals (checked before
// anything runs: too many layers, a class count the sampler cannot split
// over a warp, a row's resident rings and scratch larger than a block's
// shared memory, streamed layers without a buffer, or a fused window
// without its weights), or the cudaError_t of the attribute call or the
// launch (a launch refused for shared memory never runs, so the caller
// must check this).
extern "C" int ar_generate(
    const float* c_up, const float* noise, const float* teacher, float* out,
    const void* in_w, const void* in_b, const void* conv_w,
    const void* conv_b, const void* cond_w, const void* res_w,
    const void* res_b, const void* skip_w, const void* skip_b,
    const void* h1_w, const void* h1_b, const void* h2_w, const void* h2_b,
    const void* fm, void* strm_ring, const int* dilations,
    const int* streamed, int B, int T, int L, int R, int G, int S, int C,
    int Q, int O, int softmax, int greedy, int n_forced, int bf16, int fused,
    float log_b_min, float log_b_max, void* stream) {
  if (L < 1 || L > kMaxLayers) return kErrLayers;
  if (softmax && (Q % 32 != 0 || Q > 32 * kMaxPerLane)) return kErrClasses;
  if (fused < 0 || (fused > 0 && fm == nullptr)) return kErrFused;
  Params p;
  p.c_up = c_up; p.noise = noise; p.teacher = teacher; p.out = out;
  p.in_w = in_w; p.in_b = in_b; p.conv_w = conv_w; p.conv_b = conv_b;
  p.cond_w = cond_w; p.res_w = res_w; p.res_b = res_b;
  p.skip_w = skip_w; p.skip_b = skip_b;
  p.h1_w = h1_w; p.h1_b = h1_b; p.h2_w = h2_w; p.h2_b = h2_b;
  p.fm = fm; p.fused = fused;
  p.strm_ring = strm_ring;
  p.B = B; p.T = T; p.L = L; p.R = R; p.G = G; p.S = S; p.C = C;
  p.Q = Q; p.O = O;
  p.softmax = softmax; p.greedy = greedy; p.n_forced = n_forced;
  p.log_b_min = log_b_min; p.log_b_max = log_b_max;
  for (int l = 0; l < L; ++l) {
    p.dil[l] = dilations[l];
    p.strm[l] = streamed[l] != 0;
  }
  pack_rings(dilations, streamed, L, p.off, &p.res_rows, &p.strm_rows);
  if (p.strm_rows > 0 && strm_ring == nullptr) return kErrStreamRing;
  if (fused > 0) pack_fm(L, fused, R, G, S, p.fm_off);
  const size_t smem_bytes = smem_layout(p.res_rows, L, R, G, S, C, O,
                                        bf16 ? 2 : 4, fused > 0)
                                .bytes;
  int smem_max = 0;
  const int e = ar_smem_limit(&smem_max);
  if (e != (int)cudaSuccess) return e;
  if (smem_bytes > (size_t)smem_max) return kErrSharedMemory;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? start<__nv_bfloat16>(p, smem_bytes, s)
                    : start<float>(p, smem_bytes, s));
}

extern "C" const char* ar_error_string(int e) {
  switch (e) {
    case kErrLayers:
      return "more than 64 layers";
    case kErrClasses:
      return "softmax quantize_channels must be a multiple of 32 and <= 1024";
    case kErrSharedMemory:
      return "shared memory: one batch row's resident rings (their "
             "dilations x R x element size) and scratch exceed a block's "
             "shared memory; stream the large-dilation rings (stream=True, "
             "a smaller chunk) or store them in bfloat16";
    case kErrStreamRing:
      return "streamed layers need a global ring buffer";
    case kErrFused:
      return "fused must be >= 0, and a fused window needs its weights";
  }
  return cudaGetErrorString((cudaError_t)e);
}
