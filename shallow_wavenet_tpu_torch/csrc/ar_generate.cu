// Persistent autoregressive WaveNet generation on Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel built by `_make_kernel` and launched by
// `generate_pallas` in shallow_wavenet_tpu/ops/ar_kernel.py, in its fp32,
// resident-ring, unfused form: both heads (Laplace, softmax), sample and
// greedy modes, teacher forcing for every step or for a warm-up prefix.
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
// What bounds it on this card. Each sample is a serial chain: two dependent
// matrix-vector products per layer plus the head, and the next sample needs
// this one. At config 2 (12 layers, R=64, G=128, S=128, C=64) a sample is
// 459,008 multiply-adds per batch row (442,368 in the layers, 16,640 in
// the head), about 0.92 MFLOP, and reads all 1.8 MB of fp32 weights. The
// roofline of a whole call (FLOPs over 67 TFLOP/s, or the conditioning,
// noise and output bytes over 3.35 TB/s) is far below what the chain
// allows: one step cannot start before the previous one ends, so the time
// is T times the latency of one step.
//
// What the design does about it, simply and correctly first:
// - one launch for the whole (B, T) batch; the time loop runs inside the
//   kernel (the TPU kernel's sequential grid over chunks becomes this loop);
// - one thread block per batch row, so rows run in parallel on separate SMs
//   and a row's result never depends on the batch it was decoded in;
// - the row's packed dilation rings (layer l owns rows [off_l, off_l + d_l),
//   slot off_l + (t & (d_l - 1))), h, skip, z and the gate inputs live in
//   shared memory; the weights are read from global memory every step and
//   stay resident in the 50 MB L2;
// - the conditioning term of all layers (c_t @ V) is computed once per step
//   across all threads, off the layer-to-layer chain;
// - fp32 FMA throughout, no tensor cores.
// A step is then bound by one SM pulling all 1.8 MB of weights through its
// L2 port in a series of dependent stages (about 40 block barriers per
// step), not by arithmetic: rows run on their own SMs, so the time per
// step hardly depends on the batch. Prefetching the next stage's weights
// into shared memory, or spreading them over the shared memory of a
// cluster of SMs so each SM streams a slice, is the later, faster design.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 64;
constexpr int kMaxPerLane = 32;   // softmax classes per lane: Q <= 1024
constexpr unsigned kFull = 0xffffffffu;
// The entry point's own refusals; cudaError_t codes are >= 0.
constexpr int kErrLayers = -1, kErrClasses = -2, kErrSharedMemory = -3;

struct Params {
  const float* c_up;     // (B, T, C)
  const float* noise;    // (B, T) uniforms in (0, 1)
  const float* teacher;  // (B, T) forced inputs, or nullptr
  float* out;            // (B, T) samples, or class ids as floats
  const float* in_w;     // (1, R) projection or (Q, R) embedding
  const float* in_b;     // (R,)
  const float* conv_w;   // (L, 2, R, G); tap 0 multiplies x[t - d]
  const float* conv_b;   // (L, G)
  const float* cond_w;   // (L, C, G)
  const float* res_w;    // (L, G/2, R)
  const float* res_b;    // (L, R)
  const float* skip_w;   // (L, G/2, S)
  const float* skip_b;   // (L, S)
  const float* h1_w;     // (S, S)
  const float* h1_b;     // (S,)
  const float* h2_w;     // (S, O)
  const float* h2_b;     // (O,)
  int B, T, L, R, G, S, C, Q, O;
  int softmax, greedy, n_forced, sum_d;
  float log_b_min, log_b_max;
  int dil[kMaxLayers];
  int off[kMaxLayers];
};

// One block's dynamic shared memory, as float offsets: the only statement
// of the layout, used by the kernel to carve it and by the host to size it.
struct SmemLayout {
  size_t ring, h, c, cc, gpart, z, skip, a1, o, fb, floats;
};

__host__ __device__ inline SmemLayout smem_layout(int sum_d, int L, int R,
                                                  int G, int S, int C, int O) {
  SmemLayout m;
  size_t n = 0;
  m.ring = n;  n += (size_t)sum_d * R;  // (sum_d, R) packed rings
  m.h = n;     n += R;                  // (R) residual stream
  m.c = n;     n += C;                  // (C) conditioning at t
  m.cc = n;    n += (size_t)L * G;      // (L, G) c_t @ V for every layer
  m.gpart = n; n += 2 * G;              // (2, G) tap products
  m.z = n;     n += G / 2;              // (G/2) gated activation
  m.skip = n;  n += S;                  // (S) skip sum
  m.a1 = n;    n += S;                  // (S) head hidden
  m.o = n;     n += O;                  // (O) head output
  m.fb = n;    n += 1;                  // feedback sample or class id
  m.floats = n;
  return m;
}

// y = x . w[0], x . w[ld], ... : one output column of a row-vector product.
// The sum is one fp32 chain in k order; unrolling by 32 lets 32 independent
// weight loads be in flight at once, which is what sets a stage's time (a
// step is a series of L2 round trips, not of arithmetic).
__device__ __forceinline__ float dot_col(const float* x, const float* w,
                                         int k_len, int ld) {
  float acc = 0.f;
#pragma unroll 32
  for (int k = 0; k < k_len; ++k) acc = fmaf(x[k], w[(size_t)k * ld], acc);
  return acc;
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

__global__ void __launch_bounds__(kThreads)
ar_generate_kernel(const Params p) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int R = p.R, G = p.G, S = p.S, C = p.C, L = p.L, O = p.O;
  const int half = G / 2;
  const SmemLayout m = smem_layout(p.sum_d, L, R, G, S, C, O);
  float* ring = smem + m.ring;
  float* h = smem + m.h;
  float* c = smem + m.c;
  float* cc = smem + m.cc;
  float* gpart = smem + m.gpart;
  float* z = smem + m.z;
  float* skip = smem + m.skip;
  float* a1 = smem + m.a1;
  float* o = smem + m.o;
  float* fb = smem + m.fb;

  for (int i = tid; i < p.sum_d * R; i += kThreads) ring[i] = 0.f;
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
        h[r] = ok ? p.in_w[(size_t)id * R + r] : 0.f;
    } else {
      for (int r = tid; r < R; r += kThreads)
        h[r] = __fadd_rn(__fmul_rn(x_in, p.in_w[r]), p.in_b[r]);
    }
    for (int k = tid; k < C; k += kThreads) c[k] = c_row[(size_t)t * C + k];
    for (int s = tid; s < S; s += kThreads) skip[s] = 0.f;
    __syncthreads();
    // -- conditioning term of every layer
    for (int i = tid; i < L * G; i += kThreads) {
      const int l = i / G, g = i - l * G;
      cc[i] = dot_col(c, p.cond_w + (size_t)l * C * G + g, C, G);
    }
    __syncthreads();
    // -- residual layers
    for (int l = 0; l < L; ++l) {
      float* slot = ring + (size_t)(p.off[l] + (t & (p.dil[l] - 1))) * R;
      const float* w_l = p.conv_w + (size_t)l * 2 * R * G;
      for (int i = tid; i < 2 * G; i += kThreads) {
        const int tap = i / G, g = i - tap * G;
        gpart[i] = dot_col(tap ? h : slot, w_l + (size_t)tap * R * G + g, R, G);
      }
      __syncthreads();
      const float* b = p.conv_b + (size_t)l * G;
      const float* ccl = cc + (size_t)l * G;
      for (int j = tid; j < half; j += kThreads) {
        const float ua = ((gpart[j] + gpart[G + j]) + b[j]) + ccl[j];
        const int jb = half + j;
        const float ub = ((gpart[jb] + gpart[G + jb]) + b[jb]) + ccl[jb];
        z[j] = tanhf(ua) * (1.f / (1.f + expf(-ub)));
      }
      __syncthreads();
      // skip|res projection; the ring keeps the layer's INPUT h
      for (int n = tid; n < S + R; n += kThreads) {
        if (n < S) {
          skip[n] += dot_col(z, p.skip_w + (size_t)l * half * S + n, half, S)
                     + p.skip_b[(size_t)l * S + n];
        } else {
          const int r = n - S;
          const float res =
              dot_col(z, p.res_w + (size_t)l * half * R + r, half, R)
              + p.res_b[(size_t)l * R + r];
          slot[r] = h[r];
          h[r] += res;
        }
      }
      __syncthreads();
    }
    // -- head: relu -> dense -> relu -> dense
    for (int n = tid; n < S; n += kThreads) {
      float acc = 0.f;
#pragma unroll 32
      for (int k = 0; k < S; ++k)
        acc = fmaf(skip[k] > 0.f ? skip[k] : 0.f, p.h1_w[(size_t)k * S + n], acc);
      acc += p.h1_b[n];
      a1[n] = acc > 0.f ? acc : 0.f;
    }
    __syncthreads();
    for (int n = tid; n < O; n += kThreads)
      o[n] = dot_col(a1, p.h2_w + n, S, O) + p.h2_b[n];
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

}  // namespace

// Launch on `stream` on the current device. Returns 0, one of the kErr*
// refusals (checked before anything runs: too many layers, a class count
// the sampler cannot split over a warp, or a row's rings and scratch larger
// than a block's shared memory), or the cudaError_t of the attribute call
// or the launch (a launch refused for shared memory never runs, so the
// caller must check this).
extern "C" int ar_generate(
    const float* c_up, const float* noise, const float* teacher, float* out,
    const float* in_w, const float* in_b, const float* conv_w,
    const float* conv_b, const float* cond_w, const float* res_w,
    const float* res_b, const float* skip_w, const float* skip_b,
    const float* h1_w, const float* h1_b, const float* h2_w,
    const float* h2_b, const int* dilations, int B, int T, int L, int R,
    int G, int S, int C, int Q, int O, int softmax, int greedy, int n_forced,
    float log_b_min, float log_b_max, void* stream) {
  if (L < 1 || L > kMaxLayers) return kErrLayers;
  if (softmax && (Q % 32 != 0 || Q > 32 * kMaxPerLane)) return kErrClasses;
  Params p;
  p.c_up = c_up; p.noise = noise; p.teacher = teacher; p.out = out;
  p.in_w = in_w; p.in_b = in_b; p.conv_w = conv_w; p.conv_b = conv_b;
  p.cond_w = cond_w; p.res_w = res_w; p.res_b = res_b;
  p.skip_w = skip_w; p.skip_b = skip_b;
  p.h1_w = h1_w; p.h1_b = h1_b; p.h2_w = h2_w; p.h2_b = h2_b;
  p.B = B; p.T = T; p.L = L; p.R = R; p.G = G; p.S = S; p.C = C;
  p.Q = Q; p.O = O;
  p.softmax = softmax; p.greedy = greedy; p.n_forced = n_forced;
  p.log_b_min = log_b_min; p.log_b_max = log_b_max;
  int acc = 0;
  for (int l = 0; l < L; ++l) {
    p.dil[l] = dilations[l];
    p.off[l] = acc;
    acc += dilations[l];
  }
  p.sum_d = acc;
  const size_t smem_bytes =
      smem_layout(acc, L, R, G, S, C, O).floats * sizeof(float);
  int device = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  if (smem_bytes > (size_t)smem_max) return kErrSharedMemory;
  e = cudaFuncSetAttribute(ar_generate_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || T == 0) return (int)cudaSuccess;
  ar_generate_kernel<<<B, kThreads, smem_bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* ar_error_string(int e) {
  switch (e) {
    case kErrLayers:
      return "more than 64 layers";
    case kErrClasses:
      return "softmax quantize_channels must be a multiple of 32 and <= 1024";
    case kErrSharedMemory:
      return "shared memory: one batch row's rings (sum(dilations) x R) and "
             "scratch exceed a block's shared memory (streamed rings are "
             "ROADMAP B5)";
  }
  return cudaGetErrorString((cudaError_t)e);
}
