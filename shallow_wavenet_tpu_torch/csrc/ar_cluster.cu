// Autoregressive WaveNet generation on Hopper (sm_90a), one thread-block
// cluster of N SMs per batch row.
//
// Replaces, on the decode's path, the Pallas TPU kernel built by
// `_make_kernel` and launched by `generate_pallas` in
// shallow_wavenet_tpu/ops/ar_kernel.py, as ar_generate.cu does, and
// computes the same function as ar_generate.cu, unfused and with the fused
// window (kFused, below): both heads (Laplace, softmax), sample and
// greedy, teacher forcing for every step or a warm-up prefix, silence
// seeding, out-of-range class ids (a zero embedding), fp32 or bf16 weights
// and rings with bf16 rounded where ar_generate.cu rounds (`rnd<W>`).
// ar_generate.cu stays as the fallback where no cluster fits.
//
// What bounds ar_generate.cu: one SM per row reads every weight from L2 on
// every step (1.8 MB fp32 at config 2, 16.0 MB at deep_baseline) in a
// chain of dependent stages, while at B = 8 the other 124 SMs sit idle.
// The step follows the bytes one SM pulls, not the batch.
//
// The design here: every product is split along its input dimension
// (K-split) over the N blocks of a cluster, so each SM owns a fixed slice
// of the state and reads only 1/N of the weights:
// - rank k owns rows [kR/N, (k+1)R/N) of the residual stream h and the
//   same columns of every ring row, in its own shared memory; its tap
//   products multiply its slices of x[t-d] and h by its R/N rows of W0
//   and W1, a partial of all G gate inputs; ring reads and writes never
//   leave the SM;
// - it holds C/N rows of every layer's V, and computes its partial of
//   c_t @ V for the layer's G columns beside its tap products (from the
//   layer's weight stage, so streamed with them);
// - reduce-scatter 1: each rank stores each owner's columns of its
//   (tap, conditioning) partials into the owner's shared memory through
//   distributed shared memory (DSMEM); owner k takes columns j and
//   j + G/2 for j in its G/(2N) block, so each gate pair is local; after
//   one cluster barrier the owner sums the N partials in rank order, adds
//   the bias and gates: its G/(2N) values of z;
// - reduce-scatter 2: z @ [Ws | Wr] is split on z's rows; rank k receives
//   the partials of S/N skip outputs and of the R/N residual outputs of
//   its own h slice, writes its old h slice to its ring slot and updates
//   h += res locally;
// - the head is split on skip: relu(skip) @ H1 is reduce-scattered to
//   slices of a1, and the partials of a1 @ H2 (O = 2 for Laplace, Q for
//   softmax) are all-gathered, so that every rank sums them in rank order
//   and draws the same sample from the same uniform (rank 0 writes it);
//   no broadcast of the sample is needed.
// That is 2L + 2 exchanges per step unfused (26 at config 2, 62 at
// deep_baseline); with the fused window, ceil(L/W) + L + 2 (17 and 40 at
// W = 4).
// An exchange is point to point: each sender stores its partials into the
// owner's receive buffer with st.async, which counts the bytes on the
// owner's mbarrier, and the owner waits on that mbarrier alone. A first
// version synchronised every exchange with barrier.cluster arrive.release
// / wait.acquire, and was slower on an H100: its fences make every
// exchange a cluster-wide flush. Every
// receive buffer is double-buffered by exchange parity: a sender reaches
// exchange e + 2 only after it has received exchange e + 1 from every rank,
// which each sent after reading exchange e, so a buffer is never written
// before its reader is done, and no other synchronisation is needed.
//
// Weights: the wrapper packs each rank's slice contiguously, per stage
// (each layer's [W0|W1 interleaved by tap | V rows | Ws|Wr rows], then
// the head's [H1 rows | H2 rows]). With kResident (config 2 at N = 16:
// 119.8 KB per SM fp32, 59.9 KB bf16) the slice is copied into shared
// memory once per call and never read from L2 again. Otherwise (config 2
// fp32 at N = 8: 240 KB per SM per step; deep_baseline at N = 16: 1.02
// MB fp32) each stage is read from L2 one stage ahead into a double
// buffer with cp.async.
// The rings are always resident: split over N, deep_baseline's take
// 3,069 rows x 8 columns, 98.2 KB fp32 or 49.1 KB bf16 per SM.
//
// Summation order, a function of the model, the dtype and N only (never
// of B, so a row's samples do not depend on its batch): each rank's dot is
// one fp32 chain in k order over its slice; the tap partial is tap0 + tap1,
// then the N partials are summed in rank order; a gate input is
// ((sum of tap partials + b) + sum of conditioning partials). The plain
// version's `split=N, chain=True` does this kernel's operations one for
// one; with N = 1 that order is ar_generate.cu's (`chain=True`).
//
// The fused window (kFused; the TPU kernel's `fused_blocks` branch,
// shallow_wavenet_tpu/ops/ar_kernel.py:368-419, its weights :697-737):
// within each block of W layers the residual recurrence is expanded into
// the gate inputs, so a layer's chain is one product and one exchange:
// - block exchange: for every layer of the block, each rank sends the
//   owners its partials of tap 0 on its ring slice, of the conditioning on
//   its c slice (V rows) and of tap 1 on its slice of the block input h
//   (`w1cat`), three values per gate column; the owner forms every layer's
//   gate input, ((sum tap0 + b) + sum cond) + sum tap1, b the folded bias
//   (conv_b plus res_b @ W1_m of the block's earlier layers), and gates
//   the block's first layer;
// - layer exchange: rank k multiplies its z slice by its rows of
//   fm[l] = [skip_w | res_w | res_w @ W1_m for each later layer m of the
//   block] (G/(2N), S + R + rem G) and sends skip partials to the skip
//   owners, res partials to the h owners and each later layer's P partials
//   to that layer's gate owners; the owner first gates the next layer (a
//   lane per gate half, the pair's halves swapped by shuffle, in whole
//   warps; the block exchange's sums likewise), then, on the other warps
//   first, updates skip, h and the ring and adds the P sums into the
//   later layers' gate inputs in layer order.
// Summation order of a gate input with the fused window: each sum over
// ranks as above (per-rank chains in k order, ranks in order),
// u = ((tap0 + b) + cond) + tap1, then + P_j of each earlier layer j of
// the block in layer order; with N = 1 that is ar_generate.cu's fused
// order (`fused=W, chain=True`), and the plain version's `fused=W,
// split=N, chain=True` does this kernel's operations one for one.
// Stages, in the order a step reads them: per block, each layer's tap
// stage [W0|W1 (R/N, G, 2) | V rows (C/N, G)], then each layer's fm rows;
// then the head; each packed at its own offset (`fused_stages`), so the
// resident form holds only what it reads (config 2 fp32 at N = 16, W = 4:
// 151.6 KB), and the streamed one double-buffers the longest stage.
// Exchanges use receive buffer e & 1 for the call's e-th exchange (a
// step's count may be odd), with the bytes of each exchange of a step in
// `xbytes`.
//
// The wide form (kWide; unfused, fp32; the last layout the decode tries,
// for models whose rings and weights no other form holds): the gate width
// up to 2048 (kMaxPassW passes of the tap lanes), the rings of the large
// dilations in a global ring and the weights streamed in tiles. At the
// speaker-dependent vocoder's widths (R 512, G 1024, S 256, 256 classes,
// 30 layers) a row's rings are 6.3 MB and its fp32 weights 178 MB, beyond
// the 50 MB L2, so every step reads them from HBM: the step is bound by
// the bytes each SM pulls and by the chain, not by the operations.
// - Rings (`pack_rings_wide`): the small dilations' rings stay in shared
//   memory; a global layer writes its h slice to the global ring (B,
//   grows, R), and since its tap-0 row of step t + 1 was written d >= 2
//   steps earlier, every rank copies its slices of those rows for step
//   t + 1 with cp.async during step t (`xprev`, double-buffered by step
//   parity), off the chain.
// - Weights: the packed stages of the streamed form (`pack_cluster`), read
//   as tiles of whole rows (`wide_tiles`: per layer its tap rows, its
//   conditioning rows, its skip|res rows; then the head) through kSlots
//   slots of kTileBytes in shared memory. Thread 0 keeps kSlots tiles in
//   flight, each one bulk copy (the TMA) completing on its slot's
//   mbarrier, and refills a slot once every thread has passed the block
//   barrier after its last read; the step's tile sequence repeats, so the
//   next step's first tiles load during this step's last ones.
// - What bounds the step is not the tile stream (on an H100: 375 us a step
//   at 2 clusters and at 7 alike; with no tile loaded or waited for, 348
//   us; with no per-tile barrier either, 334 us; with no product of a tap
//   or skip|res tile, 338 us): the rest is the exchange and owner chain.
//   Asking the L2 for each tile 4 to 65 tiles ahead of its load
//   (cp.async.bulk.prefetch.L2) made the step 5% longer at 2 clusters and
//   6-40% longer at 7, so there is no such run-ahead.
// - Every product's chains, exchanges and sums are the streamed form's,
//   in the same order, so `split=N, chain=True` of the plain version is
//   its arithmetic too; only where the operands come from differs.
//
// The wrapper picks N from the model, the dtype and the card, never from
// the batch (`ar_kernel.cluster_size`): with one block per SM, an H100's
// GPCs hold only 7 clusters of 16 (112 of 132 SMs), 15 of 8. A batch
// larger than the clusters the card holds at once runs in waves.
// Rows of one batch may differ in length (a decode pads its utterances to
// the longest): with `lengths`, row r runs lengths[r] steps and stops, and
// its cluster frees its SMs for a cluster still waiting; with `order`,
// cluster k runs row order[k], so that the wrapper can launch the longest
// rows first and the last wave holds the shortest. A row's steps, inputs
// and sums are those of the padded call, so its samples within its length
// are the same to the bit; (B, T) stay the layout of every input and
// output, and the kernel never writes past a row's length. Each cluster
// reads its row and its steps from the kernel's parameters (`Params`
// row_of, len_of), filled on the host at launch: indexed by the cluster,
// they are the same for every thread and the compiler knows it. (Read
// from device memory through a pointer, the bound made it treat the time
// loop's exit as divergent, and a step took 2-3% longer on an H100.) A
// launch holds kMaxRows clusters; `launch` runs a larger batch in
// several launches.
// No library kernel stands in for any part of the recurrence; fp32 FMA,
// no tensor cores.
//
// The probe (built only with -DAR_CLUSTER_PROBE, into its own library,
// `ar_cluster_probe`): the kernel's last two template parameters. The
// production instances take A = kAblFull, kTimed = false, and every use of
// either is an `if constexpr`, so they compile to the same code as before.
// - A, an ablation of the unfused step (the port of tools/kprobe.py, whose
//   ablations csrc/ar_probe.cu defines on ar_generate.cu's body), on the
//   probe's model (Laplace head, unit input weights, zero biases), summed
//   in this kernel's order (the plain version's `split=N, chain=True`):
//     no_cond       each rank's conditioning partials computed at the first
//                   step of each chunk, kept in shared memory (`ccs`)
//     no_prev       no tap-0 product
//     no_buf        tap 0 reads h; no ring write
//     no_resskip    h += z, skip += z on each rank's own slice, no skip|res
//                   product (needs R = S = G/2, so that rank k's z slice
//                   is its h and skip slice)
//     no_head       mu = log_b = skip[0] + skip[1], unclipped, from rank 0
//   (no_resskip and no_head keep the exchanges of what they strip, one
//   float from each rank to every rank: each exchange's buffer is safe to
//   refill only once the next exchange is in, see below)
//     no_sample     x = clip(mu)
//     matmuls_only  no_cond + no_buf + no_sample
//     cheap_gate    z = rnd(u_a u_b);  no_gate  z = rnd(u_a)
//     gate_bf16     tanh and the sigmoid on inputs rounded to W, every op
//                   rounded to W (in fp32, full's function)
//     unroll2/4     the time loop unrolled by 2 / 4 (full's function)
//     local_exchange  every st.async goes to the sender's own receive
//                   buffer (in the row of the owner it was meant for), each
//                   mbarrier counts the sender's own bytes, and each owner's
//                   rank sum keeps its own row only (the others' terms
//                   selected to 0): the same instruction stream without
//                   cross-SM traffic. Its function: each owned column sums
//                   only the owner's own partial, so each rank runs alone
//                   on its slices, fed back its own draw; rank 0 writes.
//   split2 (two rows per block) is refused: two rows per cluster change
//   the production layout.
// - kTimed, a per-stage timer: thread 0 of every rank reads clock64() at
//   boundaries the kernel already has and adds the cycles since its last
//   read to one 32-bit register per stage kind (`StageKind`); once per
//   call it stores them and the time loop's cycles (from step 0's first
//   read to the last draw) into p.timer, (B, N, kTimerSlots). The step's
//   prologue (the input encoding) is in no kind: the rest.
//   Unlike every other instance, the timed one runs cluster k on row k
//   for T steps, and does not read its row and steps from the launch's
//   parameters (`Params` row_of, len_of): on the production form the
//   timer's own cost rose past chip_smoke.py's TIMER_RATIO_MAX_C2_FP32.
//   So its stage table is of that in-order, padded form of the step.
//   No barrier, fence or other memory operation is added. A product
//   stage's count is thread 0's own pass (a slower warp shows in the next
//   wait); a wait's is the cross-SM latency plus the slowest sender's
//   lateness.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <utility>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 64;
constexpr int kMaxPerLane = 32;   // softmax classes per lane: Q <= 1024
constexpr int kMaxCluster = 16;
// passes of the block over a partial's outputs (2G tap lanes, S + R
// projection outputs, S head outputs): at most 4 of 256 threads
constexpr int kMaxPass = 4;
// the fused window: W <= kMaxFused, and passes over the outputs of a fused
// projection (S + R + (W - 1) G): at most 8 of 256 threads
constexpr int kMaxFused = 16;
constexpr int kMaxPassF = 8;
constexpr int kMaxStages = 2 * kMaxLayers + 1;
// clusters per launch (their rows and steps are kernel parameters)
constexpr int kMaxRows = 512;
constexpr int kMaxExchanges = 2 * kMaxLayers + 2;
// the wide form (kWide, below): passes over at most 2G = 2048 tap lanes;
// the weight pipeline's slots in shared memory and the bytes of each; a
// rank's budget of ring rows in shared memory; weight tiles per step
constexpr int kMaxPassW = 8;
constexpr int kSlots = 4;
constexpr int kTileBytes = 32768;
constexpr int kWideRingBytes = 16384;
constexpr int kMaxTiles = 1024;
constexpr unsigned kFull = 0xffffffffu;
// The entry points' own refusals; cudaError_t codes are >= 0.
constexpr int kErrLayers = -1, kErrClasses = -2, kErrSharedMemory = -3,
              kErrSplit = -4, kErrOccupancy = -5, kErrWidth = -6,
              kErrFused = -7, kErrAblation = -8, kErrSplit2 = -9,
              kErrResSkip = -10, kErrHead = -11, kErrChunk = -12,
              kErrProbeForm = -13, kErrRows = -14, kErrWide = -15;
// `resident` of the entry points, past 0 (weights streamed a stage at a
// time from L2): resident in shared memory, or the wide form
constexpr int kResidentForm = 1, kWideForm = 2;

// The probe's ablations: tools/kprobe.py's ABLATIONS in its order (as
// csrc/ar_probe.cu numbers them), then the cluster's own.
enum Ablation : int {
  kAblFull, kNoCond, kNoPrev, kNoBuf, kNoResSkip, kNoHead, kNoSample,
  kMatmulsOnly, kCheapGate, kNoGate, kUnroll2, kUnroll4, kSplit2, kGateBf16,
  kLocalExchange, kNumAblations
};

template <int A>
struct Flags {
  static constexpr bool no_cond = A == kNoCond || A == kMatmulsOnly;
  static constexpr bool no_prev = A == kNoPrev;
  static constexpr bool no_buf = A == kNoBuf || A == kMatmulsOnly;
  static constexpr bool no_resskip = A == kNoResSkip;
  static constexpr bool no_head = A == kNoHead;
  static constexpr bool no_sample = A == kNoSample || A == kMatmulsOnly;
  static constexpr bool local = A == kLocalExchange;
  static constexpr int unroll = A == kUnroll2 ? 2 : A == kUnroll4 ? 4 : 1;
};

// The timer's stage kinds. Unfused: kWeights .. kDraw; fused: kBlockProducts
// .. kOwnerPhase, then the head's and the draw's kinds as unfused (the
// head's weight wait counts in its products). Slot kTimerSlots - 1 holds
// the time loop's cycles.
enum StageKind : int {
  kWeights, kTapProducts, kRs1Wait, kSumGate, kRsProducts, kRs2Wait,
  kOwnerUpdate, kHeadProducts, kHeadWaits, kHeadSums, kDraw,
  kBlockProducts = 0, kBlockWait, kBlockGate, kFmProducts, kFmWait,
  kOwnerPhase, kTimerSlots = 12
};

struct Params {
  const float* c_up;     // (B, T, C)
  const float* noise;    // (B, T) uniforms in (0, 1)
  const float* teacher;  // (B, T) forced inputs, or nullptr
  float* out;            // (B, T) samples, or class ids as floats
  const void* in_w;      // (1, R) projection or (Q, R) embedding, W
  const void* in_b;      // (R,)
  const void* conv_b;    // (L, G)
  const void* res_b;     // (L, R)
  const void* skip_b;    // (L, S)
  const void* h1_b;      // (S,)
  const void* h2_b;      // (O,)
  const void* stages;    // (N, total): each rank's weight slices
  int B, T, L, R, G, S, C, Q, O, N;
  int softmax, greedy, n_forced, rows;
  int stride;            // elements of a stage buffer (the longest stage)
  int total;             // elements of one rank's stages
  int fused;             // the fused window W (<= L), or 0
  int n_exch;            // exchanges per step
  float log_b_min, log_b_max;
  int dil[kMaxLayers];
  int off[kMaxLayers];   // ring row offset of each layer
  // the fused window: each stage's offset and length in a rank's slices,
  // and the bytes each owner receives in each exchange of a step
  int soff[kMaxStages], slen[kMaxStages];
  unsigned xbytes[kMaxExchanges];
  // the probe's: no_cond's chunk, and the timer's (B, N, kTimerSlots)
  // cycles
  int chunk;
  long long* timer;
  // cluster k of this launch: the row it runs and that row's steps
  int row_of[kMaxRows], len_of[kMaxRows];
  // the wide form: the global ring (B, grows, R) and each layer's place
  // (goff: its rows there, -1 where its ring is in shared memory; gidx:
  // its index among the n_glob global layers, glayer the inverse); the
  // weight tiles of one step (toff, tlen: elements of a rank's stages)
  // and the rows of each kind of tile
  void* gring;
  int grows, n_glob, n_tiles, tap_rows, v_rows, rs_rows;
  int goff[kMaxLayers], gidx[kMaxLayers], glayer[kMaxLayers];
  int toff[kMaxTiles], tlen[kMaxTiles];
};

// The widths of one rank's slices.
struct Split {
  int Rn, Hn, Cn, Sn;    // R/N, (G/2)/N, C/N, S/N
};

__host__ __device__ inline Split split_of(int R, int G, int S, int C,
                                          int N) {
  return {R / N, G / 2 / N, C / N, S / N};
}

// Elements of one stage of a rank's packed weights: a layer is
// [W0|W1 (R/N, G, 2) | V rows (C/N, G) | Ws|Wr rows (G/(2N), S + R)], the
// head [H1 rows (S/N, S) | H2 rows (S/N, O)]; every stage is padded to
// the larger, rounded up to 8 elements (16 bytes in bf16) for cp.async.
__host__ __device__ inline int stage_stride(int R, int G, int S, int C,
                                            int O, int N) {
  const Split s = split_of(R, G, S, C, N);
  const int layer = 2 * s.Rn * G + s.Cn * G + s.Hn * (S + R);
  const int head = s.Sn * (S + O);
  return ((layer > head ? layer : head) + 7) / 8 * 8;
}

// The fused window's stages of one rank, in the order a step reads them:
// per block of W layers, each layer's tap stage [W0|W1 (R/N, G, 2) | V
// rows (C/N, G)], then each layer's rows of fm (G/(2N), S + R + rem G),
// rem the later layers of its block; then the head [H1 rows | H2 rows].
// Each stage is rounded up to 8 elements (16 bytes in bf16, for cp.async)
// and packed after the last. Fills off/len (2L + 1 each) unless null.
struct Stages {
  int total, longest, count;

  __host__ __device__ void put(int n, int* off, int* len) {
    n = (n + 7) / 8 * 8;
    if (off) {
      off[count] = total;
      len[count] = n;
    }
    ++count;
    total += n;
    if (n > longest) longest = n;
  }
};

__host__ __device__ inline Stages fused_stages(int L, int R, int G, int S,
                                               int C, int O, int N, int W,
                                               int* off, int* len) {
  const Split s = split_of(R, G, S, C, N);
  Stages st = {0, 0, 0};
  for (int b0 = 0; b0 < L; b0 += W) {
    const int nb = W < L - b0 ? W : L - b0;
    for (int q = 0; q < nb; ++q) st.put((2 * s.Rn + s.Cn) * G, off, len);
    for (int q = 0; q < nb; ++q)
      st.put(s.Hn * (S + R + (nb - 1 - q) * G), off, len);
  }
  st.put(s.Sn * (S + O), off, len);
  return st;
}

// One block's dynamic shared memory: its ring slice (rows x R/N elements
// of `elem` bytes), its weights (resident: every stage; streamed: two
// stage buffers), then fp32 scratch at the float offsets below. W is the
// fused window (0: unfused); `extra`, the probe's own floats (no_cond's
// conditioning partials). The wide form (`wide`): `rows` are the rings
// kept in shared memory, followed (at byte `xprev`) by the tap-0 rows of
// the n_glob global layers for two steps; the weights are kSlots tiles;
// the mbarriers are two and one per slot. The only statement of the
// layout, used by the kernel to carve it and by the host to size it.
struct SmemLayout {
  size_t ring_bytes, weight_bytes;
  size_t xprev;         // the wide form's tap-0 rows, bytes from the start
  size_t recv_each;     // floats per parity of the receive buffer
  size_t bar, recv, h, c, z, skip, a1, o, fb, cb, rsb, h1b, h2b, inw, inb,
      u, ccs;
  size_t floats, bytes;
};

__host__ __device__ inline SmemLayout smem_layout(int rows, int L, int R,
                                                  int G, int S, int C,
                                                  int O, int N, int elem,
                                                  bool resident, int W,
                                                  int extra = 0,
                                                  bool wide = false,
                                                  int n_glob = 0) {
  const Split s = split_of(R, G, S, C, N);
  SmemLayout m;
  m.ring_bytes = ((size_t)rows * s.Rn * elem + 15) / 16 * 16;
  m.xprev = m.ring_bytes;
  if (wide)
    m.ring_bytes += ((size_t)2 * n_glob * s.Rn * elem + 15) / 16 * 16;
  size_t welems, r;
  if (W) {
    const Stages st = fused_stages(L, R, G, S, C, O, N, W, nullptr, nullptr);
    welems = resident ? (size_t)st.total : 2 * (size_t)st.longest;
    r = 3 * (size_t)W * G;                 // (N, W, G/N) float2, then float
    if ((size_t)(S + R + (W - 1) * G) > r) r = S + R + (W - 1) * G;
  } else {
    const int stride = stage_stride(R, G, S, C, O, N);
    welems = (resident ? L + 1 : 2) * (size_t)stride;
    r = 2 * (size_t)G;                             // (N, G/N) float2
    if ((size_t)(S + R) > r) r = S + R;            // (N, S/N + R/N)
  }
  if (wide) welems = (size_t)kSlots * (kTileBytes / elem);
  m.weight_bytes = (welems * elem + 15) / 16 * 16;
  if ((size_t)N * O > r) r = (size_t)N * O;        // (N, O); S/N * N = S
  m.recv_each = (r + 3) / 4 * 4;
  size_t n = 0;
  m.bar = n;                         // two mbarriers (8 bytes each); wide:
  n += wide ? 4 + 2 * kSlots : 4;    // one more per weight slot
  m.recv = n;  n += 2 * m.recv_each;               // two parities
  m.h = n;     n += s.Rn;            // this rank's slice of h
  m.c = n;     n += s.Cn;            // its slice of c_t
  m.z = n;     n += (W ? 2 : 1) * s.Hn;  // its gated activations (fused:
                                         // two, by layer parity)
  m.skip = n;  n += s.Sn;            // its skip sums
  m.a1 = n;    n += s.Sn;            // its head hidden values
  m.o = n;     n += O;               // the head output (every rank)
  m.fb = n;    n += 1;               // feedback sample or class id
  m.cb = n;    n += (size_t)L * 2 * s.Hn;          // its gate biases
  m.rsb = n;   n += (size_t)L * (s.Sn + s.Rn);     // its skip|res biases
  m.h1b = n;   n += s.Sn;
  m.h2b = n;   n += O;
  m.inw = n;   n += s.Rn;            // Laplace input projection slice
  m.inb = n;   n += s.Rn;
  m.u = n;     n += (size_t)W * 2 * s.Hn;  // fused: the block's gate inputs
  m.ccs = n;   n += extra;           // the probe's no_cond: (L, G) partials
  m.floats = n;
  m.bytes = m.ring_bytes + m.weight_bytes + n * sizeof(float);
  return m;
}

void pack_rings(const int* dil, int L, int* off, int* rows) {
  *rows = 0;
  for (int l = 0; l < L; ++l) {
    off[l] = *rows;
    *rows += dil[l];
  }
}

// The wide form's rings. A layer keeps its ring in shared memory when its
// dilation is at most the largest d for which a rank's slice of the rings
// of every layer of dilation <= d fits kWideRingBytes (dilation 1 always:
// its row is read the step after it is written); the others' rings go to
// the global ring, (B, grows, R), where each tap-0 row is known a step
// ahead. Fills off (shared rows), goff (global rows, -1 where shared),
// gidx (index among the global layers, -1 where shared) and glayer (the
// global layers in order).
void pack_rings_wide(const int* dil, int L, int Rn, int elem, int* off,
                     int* goff, int* gidx, int* glayer, int* rows,
                     int* grows, int* n_glob) {
  int keep = 1;
  for (int k = 0; k < L; ++k) {
    long long bytes = 0;
    for (int l = 0; l < L; ++l)
      if (dil[l] <= dil[k]) bytes += (long long)dil[l] * Rn * elem;
    if (bytes <= kWideRingBytes && dil[k] > keep) keep = dil[k];
  }
  *rows = *grows = *n_glob = 0;
  for (int l = 0; l < L; ++l) {
    if (dil[l] <= keep) {
      off[l] = *rows;
      *rows += dil[l];
      goff[l] = gidx[l] = -1;
    } else {
      off[l] = 0;
      goff[l] = *grows;
      *grows += dil[l];
      gidx[l] = *n_glob;
      glayer[(*n_glob)++] = l;
    }
  }
}

// The wide form's weight tiles of one step, in the order the kernel reads
// them from a rank's packed stages (`stage_stride` apart, as streamed):
// per layer, its tap rows (tap_rows rows of 2G elements a tile), its
// conditioning rows (v_rows of G), its skip|res rows (rs_rows of S + R);
// then the head's stage whole (H1 and H2 rows, rounded up to 8). Each
// kind takes as many whole rows as one tile of kTileBytes holds. Fills
// off/len unless null; returns the count.
struct Tiles {
  int tap_rows, v_rows, rs_rows;
};

inline Tiles wide_tile_rows(int G, int S, int R, int elem) {
  const int te = kTileBytes / elem;
  return {te / (2 * G), te / G, te / (S + R)};
}

int wide_tiles(int L, int R, int G, int S, int C, int O, int N, int elem,
               int* off, int* len) {
  const Split s = split_of(R, G, S, C, N);
  const Tiles t = wide_tile_rows(G, S, R, elem);
  const int stride = stage_stride(R, G, S, C, O, N);
  int n = 0;
  auto put = [&](int at, int elems) {
    if (off && n < kMaxTiles) {
      off[n] = at;
      len[n] = elems;
    }
    ++n;
  };
  for (int l = 0; l < L; ++l) {
    const int base = l * stride;
    for (int r0 = 0; r0 < s.Rn; r0 += t.tap_rows)
      put(base + r0 * 2 * G, (s.Rn - r0 < t.tap_rows ? s.Rn - r0
                                                     : t.tap_rows) * 2 * G);
    for (int q0 = 0; q0 < s.Cn; q0 += t.v_rows)
      put(base + 2 * s.Rn * G + q0 * G,
          (s.Cn - q0 < t.v_rows ? s.Cn - q0 : t.v_rows) * G);
    for (int j0 = 0; j0 < s.Hn; j0 += t.rs_rows)
      put(base + (2 * s.Rn + s.Cn) * G + j0 * (S + R),
          (s.Hn - j0 < t.rs_rows ? s.Hn - j0 : t.rs_rows) * (S + R));
  }
  put(L * stride, (s.Sn * (S + O) + 7) / 8 * 8);
  return n;
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

// Terms loaded ahead of their adds, for the head's dots and the owners'
// rank-order sums: their lengths are known only at run time, so an
// unrolled loop would run its serial remainder, each add waiting for its
// own load; here every chunk's loads are issued before its adds. Terms
// past the end are exact zeros, which leave a chain unchanged: it starts
// at +0 and an fp32 sum is -0 only when both terms are, so it never holds
// -0. (The tap and skip|res loops stay plain unrolled loops: chunked
// there, they timed slower on an H100.)
constexpr int kChunk = 8;

struct Identity {
  __device__ float operator()(float v) const { return v; }
};
// relu, then the storage type's rounding: the head's input
template <typename W> struct ReluRound {
  __device__ float operator()(float v) const {
    return rnd<W>(v > 0.f ? v : 0.f);
  }
};

// f(x[0]) w[0] + f(x[1]) w[ld] + ... over k < n: one fp32 chain of FMAs
// in k order from 0, as ar_generate.cu's dot_col over a slice.
template <typename X, typename W, typename F = Identity>
__device__ __forceinline__ float dot_chain(const X* x, const W* w, int n,
                                           size_t ld, F f = F()) {
  float acc = 0.f;
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    float xv[kChunk], wv[kChunk];
    #pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const bool ok = k0 + q < n;
      xv[q] = ok ? f(to_f(x[k0 + q])) : 0.f;
      wv[q] = ok ? to_f(w[(size_t)(k0 + q) * ld]) : 0.f;
    }
    #pragma unroll
    for (int q = 0; q < kChunk; ++q) acc = fmaf(xv[q], wv[q], acc);
  }
  return acc;
}

// x[0] + x[ld] + ... + x[(n - 1) ld], added in rank order.
__device__ __forceinline__ float rank_sum(const float* x, int n, int ld) {
  float acc = x[0];
  for (int k0 = 1; k0 < n; k0 += kChunk) {
    float v[kChunk];
    #pragma unroll
    for (int q = 0; q < kChunk; ++q)
      v[q] = k0 + q < n ? x[(k0 + q) * ld] : 0.f;
    #pragma unroll
    for (int q = 0; q < kChunk; ++q) acc += v[q];
  }
  return acc;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// The same shared-memory address in block `rank` of the cluster.
__device__ __forceinline__ unsigned mapa(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// One arrival that also expects `bytes` of st.async stores this phase.
__device__ __forceinline__ void mbar_arm(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n"
      ::"r"(bar), "r"(bytes)
      : "memory");
}
// Waits for the phase of `parity` to complete; the stores it counted, from
// any block of the cluster, are then visible. kCta acquires at this
// block's scope alone, which is enough where only this block's own bulk
// copies complete the phase (the wide form's weight slots). A wait that
// never ends is a fault of the exchange: trap, rather than hang the card.
template <bool kCta = false>
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    if constexpr (kCta)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], "
          "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1ll << 24)) __trap();
  }
}
// Stores into another block's shared memory (`addr`, `bar` from mapa) and
// counts the bytes on that block's mbarrier.
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "f"(v), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, float a, float b,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr), "f"(a), "f"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One bulk copy (the TMA's non-tensor form) of `bytes` from global memory
// into this block's shared memory at `dst`, completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Starts the copy of one stage (`stride` elements) into shared memory.
template <typename W>
__device__ __forceinline__ void copy_stage(W* dst, const W* src, int stride,
                                           int tid) {
  const int chunks = stride * (int)sizeof(W) / 16;
  for (int i = tid; i < chunks; i += kThreads)
    cp_async16(reinterpret_cast<char*>(dst) + 16 * i,
               reinterpret_cast<const char*>(src) + 16 * i);
  cp_async_commit();
}

// One softmax draw by warp 0 (ar_generate.cu's, unchanged): id =
// clip(#{q : cdf(q) < u}, 0, Q-1), or the first argmax when greedy. Lane l
// holds classes [l*per, (l+1)*per).
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
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i)
    if (i < per) { run += v[i] / tot; v[i] = run; }
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

// gate(u_a, u_b): tanh(u_a) sigmoid(u_b), in the storage type
template <typename W>
__device__ __forceinline__ float gate(float ua, float ub) {
  return rnd<W>(tanhf(ua) * (1.f / (1.f + expf(-ub))));
}

// z from the gate inputs under ablation A (the probe's; kAblFull: gate)
template <typename W, int A>
__device__ __forceinline__ float gate_of(float ua, float ub) {
  if constexpr (A == kNoGate) {
    return rnd<W>(ua);
  } else if constexpr (A == kCheapGate) {
    return rnd<W>(ua * ub);
  } else if constexpr (A == kGateBf16) {
    const float th = rnd<W>(tanhf(rnd<W>(ua)));
    const float sg = rnd<W>(1.f / rnd<W>(1.f + rnd<W>(expf(-rnd<W>(ub)))));
    return rnd<W>(th * sg);
  } else {
    return rnd<W>(tanhf(ua) * (1.f / (1.f + expf(-ub))));
  }
}

// local_exchange's rank sum: x[0] + x[ld] + ... + x[(n - 1) ld] in rank
// order with every row but `own` selected to 0, so the owner's own partial
// only, at rank_sum's loads and adds.
__device__ __forceinline__ float own_sum(const float* x, int n, int ld,
                                         int own) {
  float acc = own == 0 ? x[0] : 0.f;
  for (int k0 = 1; k0 < n; k0 += kChunk) {
    float v[kChunk];
    #pragma unroll
    for (int q = 0; q < kChunk; ++q)
      v[q] = k0 + q < n ? x[(k0 + q) * ld] : 0.f;
    #pragma unroll
    for (int q = 0; q < kChunk; ++q) acc += k0 + q == own ? v[q] : 0.f;
  }
  return acc;
}

// One block per SM (rows and ranks on their own SMs), as ar_generate.cu.
// kFused: the fused window (p.fused = W); A, kTimed: the probe's ablation
// and timer; kWide: the wide form (unfused, weights streamed); see the
// header.
template <typename W, bool kResident, bool kFused, int A = kAblFull,
          bool kTimed = false, bool kWide = false>
__global__ void __launch_bounds__(kThreads, 1)
ar_cluster_kernel(const Params p) {
  using F = Flags<A>;
  // passes of the block over the 2G tap lanes
  constexpr int P = kWide ? kMaxPassW : kMaxPass;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = p.N;
  const int rank = (int)cluster.block_rank();
  // the timed instance runs row k on cluster k for T steps (see the
  // header; the probe's entry refuses lengths and order)
  const int row = kTimed ? (int)(blockIdx.x / N) : p.row_of[blockIdx.x / N];
  const int steps = kTimed ? p.T : p.len_of[blockIdx.x / N];   // this row's
  const int tid = threadIdx.x;
  const int L = p.L, R = p.R, G = p.G, S = p.S, C = p.C, O = p.O;
  const int half = G / 2;
  const Split sp = split_of(R, G, S, C, N);
  const int Rn = sp.Rn, Hn = sp.Hn, Cn = sp.Cn, Sn = sp.Sn;
  const int stride = p.stride;
  const int Wf = kFused ? p.fused : 0;

  const SmemLayout m = smem_layout(p.rows, L, R, G, S, C, O, N, sizeof(W),
                                   kResident, Wf, F::no_cond ? L * G : 0,
                                   kWide, p.n_glob);
  W* ring = reinterpret_cast<W*>(smem);
  W* xprev = reinterpret_cast<W*>(smem + m.xprev);   // the wide form's
  W* wsm = reinterpret_cast<W*>(smem + m.ring_bytes);
  float* f = reinterpret_cast<float*>(smem + m.ring_bytes + m.weight_bytes);
  const unsigned bar0 = smem_u32(f + m.bar);   // buffer b's: bar0 + 8 b
  float* recv = f + m.recv;
  float* h = f + m.h;
  float* c = f + m.c;
  float* z = f + m.z;
  float* skip = f + m.skip;
  float* a1 = f + m.a1;
  float* o = f + m.o;
  float* fb = f + m.fb;
  float* cb = f + m.cb;
  float* rsb = f + m.rsb;
  float* h1b = f + m.h1b;
  float* h2b = f + m.h2b;
  float* inw = f + m.inw;
  float* inb = f + m.inb;
  float* u = f + m.u;
  float* ccs = f + m.ccs;
  // the timer: thread 0's cycles per stage kind since its last read, and
  // its first read of the time loop, in 32 bits (the counts of one call
  // stay below 2^32 cycles, about 2 s)
  unsigned tk[kTimerSlots] = {}, last = 0, first = 0;
  auto mark = [&](int kind) {
    if constexpr (kTimed) {
      if (tid == 0) {
        const unsigned now = (unsigned)clock64();
        tk[kind] += now - last;
        last = now;
      }
    }
  };
  auto restart = [&](int t) {
    if constexpr (kTimed) {
      last = (unsigned)clock64();
      if (t == 0) first = last;
    }
  };

  const W* stages = static_cast<const W*>(p.stages) + (size_t)rank * p.total;
  const W* in_w = static_cast<const W*>(p.in_w);

  // -- this rank's biases and input projection, fp32; zero ring
  {
    const W* conv_b = static_cast<const W*>(p.conv_b);
    const W* skip_b = static_cast<const W*>(p.skip_b);
    const W* res_b = static_cast<const W*>(p.res_b);
    for (int i = tid; i < L * 2 * Hn; i += kThreads) {
      const int l = i / (2 * Hn), cl = i % (2 * Hn);
      const int g = cl < Hn ? rank * Hn + cl : half + rank * Hn + cl - Hn;
      cb[i] = to_f(conv_b[(size_t)l * G + g]);
    }
    for (int i = tid; i < L * (Sn + Rn); i += kThreads) {
      const int l = i / (Sn + Rn), n = i % (Sn + Rn);
      rsb[i] = n < Sn ? to_f(skip_b[(size_t)l * S + rank * Sn + n])
                      : to_f(res_b[(size_t)l * R + rank * Rn + n - Sn]);
    }
    for (int n = tid; n < Sn; n += kThreads)
      h1b[n] = to_f(static_cast<const W*>(p.h1_b)[rank * Sn + n]);
    for (int n = tid; n < O; n += kThreads)
      h2b[n] = to_f(static_cast<const W*>(p.h2_b)[n]);
    if (!p.softmax)
      for (int r = tid; r < Rn; r += kThreads) {
        inw[r] = to_f(in_w[rank * Rn + r]);
        inb[r] = to_f(static_cast<const W*>(p.in_b)[rank * Rn + r]);
      }
  }
  for (int i = tid; i < p.rows * Rn; i += kThreads) ring[i] = from_f<W>(0.f);
  // The global inputs of step t + 1 (this rank's conditioning slice, the
  // uniform, the teacher sample), loaded during step t, off the chain.
  const float* c_row = p.c_up + (size_t)row * p.T * C + rank * Cn;
  float c_in = 0.f, u_in = 0.f, x_in = 0.f;
  auto load_inputs = [&](int t) {
    if (t >= steps) return;
    const size_t bt = (size_t)row * p.T + t;
    if (tid < Cn) c_in = c_row[(size_t)t * C + tid];
    if (tid < 32) u_in = p.noise[bt];
    if (tid == 0 && t < p.n_forced) x_in = p.teacher[bt];
  };
  load_inputs(0);
  // fb: the next step's input, a teacher sample or the sample just drawn
  // (silence before the first)
  if (tid == 0)
    fb[0] = p.n_forced > 0 ? x_in : p.softmax ? (float)(p.Q / 2) : 0.f;
  // stage s of a rank's slices: unfused, at s * stride; fused, packed
  const int n_stages = kFused ? 2 * L + 1 : L + 1;
  auto stage_at = [&](int s) -> size_t {
    return kFused ? (size_t)p.soff[s] : (size_t)s * stride;
  };
  if constexpr (kResident) {
    // every stage: copied once, never read from L2 again
    const size_t n_st = (size_t)p.total;
    for (size_t i = tid; i < n_st; i += kThreads) wsm[i] = stages[i];
  } else if constexpr (!kWide) {
    copy_stage(wsm, stages, kFused ? p.slen[0] : stride, tid);  // stage 0
  }
  // The wide form's weight pipeline: the call's tile n (the step's tiles,
  // p.toff / p.tlen, over and over) lands in slot n % kSlots, on that
  // slot's mbarrier (tbar0 + 8 slot). Every thread waits for tile tc;
  // thread 0 refills a slot with the tile kSlots later once every thread
  // has passed a block barrier after its last read of it (`tile_done`),
  // and issues no tile past the call's last (`left`). Only this block's
  // bulk copies complete a slot's phase, so the wait acquires at the
  // block's scope.
  const unsigned tbar0 = bar0 + 16;
  constexpr int kTileElems = kTileBytes / (int)sizeof(W);
  unsigned tc = 0, next_n = 0;   // tiles consumed; the next one to issue
  int next_k = 0;                // its index in the step's tiles
  long long left = kWide ? (long long)steps * p.n_tiles : 0;
  auto tile_issue = [&]() {
    const unsigned slot = next_n % kSlots;
    const unsigned bytes = (unsigned)p.tlen[next_k] * sizeof(W);
    mbar_arm(tbar0 + 8 * slot, bytes);
    bulk_load(smem_u32(wsm + (size_t)slot * kTileElems),
              stages + p.toff[next_k], bytes, tbar0 + 8 * slot);
    next_k = next_k + 1 == p.n_tiles ? 0 : next_k + 1;
    ++next_n;
    --left;
  };
  auto tile_wait = [&]() -> const W* {
    const unsigned slot = tc % kSlots;
    mbar_wait<true>(tbar0 + 8 * slot, (tc / kSlots) & 1u);
    return wsm + (size_t)slot * kTileElems;
  };
  auto tile_done = [&]() {
    if (tid == 0 && left > 0) tile_issue();
    ++tc;
  };
  // The wide form's tap-0 rows of step t's global layers, copied by
  // cp.async into xprev[t & 1] during step t - 1 (each was written d >= 2
  // steps before), each rank its own slices.
  W* gring = static_cast<W*>(p.gring);
  auto prefetch = [&](int t) {
    if (t >= steps) return;
    const int cpl = Rn * (int)sizeof(W) / 16;     // 16-byte copies a row
    char* dst = reinterpret_cast<char*>(xprev + (size_t)(t & 1) * p.n_glob
                                                    * Rn);
    for (int i = tid; i < p.n_glob * cpl; i += kThreads) {
      const int g = i / cpl, q = i - g * cpl;
      const int l = p.glayer[g];
      const W* src = gring + ((size_t)row * p.grows + p.goff[l]
                              + (t & (p.dil[l] - 1))) * R + rank * Rn;
      cp_async16(dst + ((size_t)g * Rn * sizeof(W) + 16 * q),
                 reinterpret_cast<const char*>(src) + 16 * q);
    }
    cp_async_commit();
  };
  if constexpr (kWide) prefetch(0);
  // The exchanges of a step, in order, unfused: per layer, reduce-scatter
  // 1 on receive buffer 0 and 2 on buffer 1; then the head's
  // reduce-scatter on buffer 0 and the gather on buffer 1. Fused: the
  // call's e-th exchange on buffer e & 1, its bytes p.xbytes[e mod
  // n_exch]. Each buffer has an mbarrier that
  // completes a phase when its one local arrival (which also states the
  // bytes to expect) and every sender's st.async bytes are in. The
  // receiver re-arms a buffer for its next exchange right after its wait,
  // before this block sends anything more, so no byte of the next exchange
  // (whose senders need this block's next send first) can come before.
  // (the probe's no_resskip and no_head keep these exchanges, one float
  // from each rank in place of the products they strip: every exchange
  // stays ordered by the next one, as above)
  const unsigned rs1_bytes = N * 2 * Hn * 8,
                 rs2_bytes = F::no_resskip ? N * 4 : N * (Sn + Rn) * 4,
                 head_bytes = F::no_head ? N * 4 : N * Sn * 4,
                 gather_bytes = F::no_head ? N * 4 : N * O * 4;
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    if constexpr (kWide)
      for (int s = 0; s < kSlots; ++s) mbar_init(tbar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arm(bar0, kFused ? p.xbytes[0] : rs1_bytes);
    mbar_arm(bar0 + 8, kFused ? p.xbytes[1 % p.n_exch] : rs2_bytes);
  }
  // every block of the cluster runs, its mbarriers armed, before the first
  // DSMEM store
  cluster.sync();
  if constexpr (kWide)   // the first tiles
    if (tid == 0)
      for (int s = 0; s < kSlots && left > 0; ++s) tile_issue();
  unsigned phase = 0;   // bit b: the parity of buffer b's next phase
  // Each thread's destinations (an owner's receive slot and mbarrier, in
  // the cluster's address space), the same at every layer and step.
  unsigned tap_dst[P], tap_bar[P], rs_dst[kMaxPass], rs_bar[kMaxPass],
      head_dst[kMaxPass], head_bar[kMaxPass];
  // fused: (owner << 16 | column) of each tap lane's gate column, and
  // (owner << 16 | slot) of each fused projection output, the slot in one
  // rank's part of the owner's receive buffer
  int tap_to[kMaxPass], fm_to[kMaxPassF];
  #pragma unroll
  for (int ps = 0; ps < kMaxPass; ++ps) {
    const int i = tid + ps * kThreads;
    const int g = i >> 1, j = g < half ? g : g - half;
    const int owner = min(j / Hn, N - 1);
    const int col = (g < half ? 0 : Hn) + j % Hn;
    if constexpr (kFused) {
      tap_to[ps] = owner << 16 | col;
      continue;
    }
    // (local_exchange: into this rank's own buffer, in the owner's row)
    tap_dst[ps] = mapa(smem_u32(recv + 2 * ((F::local ? owner : rank) * 2
                                            * Hn + col)),
                       F::local ? rank : owner);
    tap_bar[ps] = mapa(bar0, F::local ? rank : owner);
    const int n = i;                // a skip|res output
    const int ro = min(n < S ? n / Sn : (n - S) / Rn, N - 1);
    const int loc = n < S ? n % Sn : Sn + (n - S) % Rn;
    rs_dst[ps] = mapa(smem_u32(recv + m.recv_each
                               + (F::local ? ro : rank) * (Sn + Rn) + loc),
                      F::local ? rank : ro);
    rs_bar[ps] = mapa(bar0 + 8, F::local ? rank : ro);
    const int ho = min(n / Sn, N - 1);   // a head output
    head_dst[ps] = mapa(smem_u32(recv + (F::local ? ho : rank) * Sn
                                 + n % Sn),
                        F::local ? rank : ho);
    head_bar[ps] = mapa(bar0, F::local ? rank : ho);
  }
  if constexpr (kWide) {
    // the wide form's further tap lanes (as above, unfused)
    #pragma unroll
    for (int ps = kMaxPass; ps < P; ++ps) {
      const int i = tid + ps * kThreads;
      const int g = i >> 1, j = g < half ? g : g - half;
      const int owner = min(j / Hn, N - 1);
      const int col = (g < half ? 0 : Hn) + j % Hn;
      tap_dst[ps] = mapa(smem_u32(recv + 2 * (rank * 2 * Hn + col)), owner);
      tap_bar[ps] = mapa(bar0, owner);
    }
  }
  if constexpr (kFused) {
    #pragma unroll
    for (int ps = 0; ps < kMaxPassF; ++ps) {
      const int n = tid + ps * kThreads;
      int owner, loc;
      if (n < S) {
        owner = n / Sn;
        loc = n % Sn;
      } else if (n < S + R) {
        owner = (n - S) / Rn;
        loc = Sn + (n - S) % Rn;
      } else {   // P toward the (e / G + 1)-th later layer, gate column g
        const int e = n - S - R, q = e / G, g = e % G;
        const int j = g < half ? g : g - half;
        owner = j / Hn;
        loc = Sn + Rn + q * 2 * Hn + (g < half ? 0 : Hn) + j % Hn;
      }
      fm_to[ps] = min(owner, N - 1) << 16 | loc;
    }
  }
  // waits for buffer b's exchange, then arms it for `next_bytes`
  auto received = [&](int b, unsigned next_bytes) {
    mbar_wait(bar0 + 8 * b, (phase >> b) & 1u);
    phase ^= 1u << b;
    if (tid == 0) mbar_arm(bar0 + 8 * b, next_bytes);
  };
  // fused: the call's exchanges so far (the current one's buffer is
  // ex & 1) and the current one's index in the step
  int ex = 0, xi = 0;
  auto exchanged = [&]() {
    int next = xi + 2;
    if (next >= p.n_exch) next -= p.n_exch;
    received(ex & 1, p.xbytes[next]);
    ++ex;
    xi = xi + 1 == p.n_exch ? 0 : xi + 1;
  };

  int st = 0;   // stages so far (streamed weights): the stage buffer
  // The weights of stage s (unfused: layers 0..L-1, then the head; fused:
  // `fused_stages`' order): resident, in place; streamed, the copy started
  // one stage earlier, with the next stage's copy started into the other
  // buffer first. The other buffer's last readers (the previous stage's)
  // finished before a __syncthreads that every thread has passed.
  auto stage_weights = [&](int s) -> const W* {
    if constexpr (kResident) {
      return wsm + stage_at(s);
    } else if constexpr (kWide) {
      return tile_wait();   // the head: one tile (`tile_done` after it)
    } else {
      const int next = s + 1 == n_stages ? 0 : s + 1;
      copy_stage(wsm + (size_t)((st + 1) & 1) * stride,
                 stages + stage_at(next), kFused ? p.slen[next] : stride,
                 tid);
      cp_async_wait1();
      __syncthreads();
      const W* w = wsm + (size_t)(st & 1) * stride;
      ++st;
      return w;
    }
  };

  // local_exchange's rank sums keep the owner's own row only
  auto rsum = [&](const float* x, int ld) {
    if constexpr (F::local) return own_sum(x, N, ld, rank);
    else return rank_sum(x, N, ld);
  };
  #pragma unroll (Flags<A>::unroll)
  for (int t = 0; t < steps; ++t) {
    const size_t bt = (size_t)row * p.T + t;
    const float c_t = c_in, u_t = u_in;
    load_inputs(t + 1);
    if constexpr (kWide) {
      cp_async_wait0();   // this step's tap-0 rows (the barrier below
      prefetch(t + 1);    // shows them to every thread); the next step's
    }
    // -- this rank's slices: encoded input, conditioning frame; zero skip
    const float x_t = fb[0];
    if (p.softmax) {
      const int id = (int)x_t;
      const bool ok = id >= 0 && id < p.Q;   // one-hot of an out-of-range id is 0
      for (int r = tid; r < Rn; r += kThreads)
        h[r] = ok ? to_f(in_w[(size_t)id * R + rank * Rn + r]) : 0.f;
    } else {
      const float xw = rnd<W>(x_t);
      for (int r = tid; r < Rn; r += kThreads)
        h[r] = rnd<W>(__fadd_rn(rnd<W>(__fmul_rn(xw, inw[r])), inb[r]));
    }
    if (tid < Cn) c[tid] = rnd<W>(c_t);
    for (int s = tid; s < Sn; s += kThreads) skip[s] = 0.f;
    __syncthreads();
    restart(t);
    // -- residual layers
    if constexpr (kFused) {
      int s = 0;   // the step's stages so far
      for (int b0 = 0; b0 < L; b0 += Wf) {
        const int nb = min(Wf, L - b0);
        // block exchange: each layer's (tap 0, conditioning) and tap 1
        // partials into the owner of each gate column; lane pair (g, tap)
        // as unfused
        const int xb = ex & 1;
        const unsigned rbuf = smem_u32(recv + xb * m.recv_each);
        const unsigned bar = bar0 + 8 * xb;
        const int t1 = 2 * Wf * G;       // the tap 1 partials' offset
        for (int k = 0; k < nb; ++k) {
          const int l = b0 + k;
          // streamed: the last tap stage's readers are done before its
          // buffer is refilled
          if (!kResident && k > 0) __syncthreads();
          const W* w = stage_weights(s++);
          const W* slot =
              ring + ((size_t)p.off[l] + (t & (p.dil[l] - 1))) * Rn;
          #pragma unroll
          for (int ps = 0; ps < kMaxPass; ++ps) {
            const int i = tid + ps * kThreads;
            if (i >= 2 * G) break;
            const int g = i >> 1, tap = i & 1;
            const W* wt = w + (size_t)g * 2 + tap;
            float acc = 0.f;
            #pragma unroll 8
            for (int r = 0; r < Rn; ++r) {
              const float x = tap ? h[r] : to_f(slot[r]);
              acc = fmaf(x, to_f(wt[(size_t)r * 2 * G]), acc);
            }
            const int owner = tap_to[ps] >> 16;
            const int at = (rank * Wf + k) * 2 * Hn + (tap_to[ps] & 0xffff);
            const unsigned ob = mapa(bar, owner);
            if (!tap) {
              const W* v = w + (size_t)2 * Rn * G + g;
              float cond = 0.f;
              #pragma unroll 8
              for (int q = 0; q < Cn; ++q)
                cond = fmaf(c[q], to_f(v[(size_t)q * G]), cond);
              st_async(mapa(rbuf + 8 * at, owner), acc, cond, ob);
            } else {
              st_async(mapa(rbuf + 4 * (t1 + at), owner), acc, ob);
            }
          }
          mark(kBlockProducts);
        }
        exchanged();
        mark(kBlockWait);
        // owner: every layer's gate input, ((tap 0 + b) + cond) + tap 1,
        // each summed over ranks in rank order, one lane per gate half
        // (whole warps run each pass: the pair swaps halves); the first
        // layer gated by the pair's even lane
        {
          const float2* r2 =
              reinterpret_cast<const float2*>(recv + xb * m.recv_each);
          const float* r1 = recv + xb * m.recv_each + t1;
          const int ld = Wf * 2 * Hn;   // one rank's part
          const int n2 = nb * 2 * Hn;
          for (int i = tid; i < (n2 + 31) / 32 * 32; i += kThreads) {
            const int side = i & 1, kj = i >> 1;
            const int k = kj / Hn, j = kj - k * Hn;
            float v = 0.f;
            if (i < n2) {
              const int at = k * 2 * Hn + side * Hn + j;
              float2 a = r2[at];
              float b = r1[at];
              for (int k0 = 1; k0 < N; k0 += kChunk) {
                float2 av[kChunk];
                float bv[kChunk];
                #pragma unroll
                for (int q = 0; q < kChunk; ++q) {
                  const int r = k0 + q;
                  av[q] = r < N ? r2[r * ld + at] : make_float2(0.f, 0.f);
                  bv[q] = r < N ? r1[r * ld + at] : 0.f;
                }
                #pragma unroll
                for (int q = 0; q < kChunk; ++q) {
                  a.x += av[q].x; a.y += av[q].y; b += bv[q];
                }
              }
              v = ((a.x + cb[(size_t)(b0 + k) * 2 * Hn + side * Hn + j])
                   + a.y) + b;
            }
            const float other = __shfl_xor_sync(kFull, v, 1);
            if (i < n2 && !side) {
              if (k == 0) {
                z[j] = gate<W>(v, other);
              } else {
                u[k * 2 * Hn + j] = v;
                u[k * 2 * Hn + Hn + j] = other;
              }
            }
          }
          __syncthreads();
          mark(kBlockGate);
        }
        for (int k = 0; k < nb; ++k) {
          const int l = b0 + k, rem = nb - 1 - k;
          const W* w = stage_weights(s++);
          // z @ fm[l] over this rank's rows of z, into the owners
          const float* zk = z + (k & 1) * Hn;
          const int nout = S + R + rem * G, per = Sn + Rn + rem * 2 * Hn;
          const int lb = ex & 1;
          const unsigned lbuf =
              smem_u32(recv + lb * m.recv_each) + 4 * rank * per;
          const unsigned lbar = bar0 + 8 * lb;
          #pragma unroll
          for (int ps = 0; ps < kMaxPassF; ++ps) {
            const int n = tid + ps * kThreads;
            if (n >= nout) break;
            float acc = 0.f;
            #pragma unroll 8
            for (int j = 0; j < Hn; ++j)
              acc = fmaf(zk[j], to_f(w[(size_t)j * nout + n]), acc);
            const int owner = fm_to[ps] >> 16;
            st_async(mapa(lbuf + 4 * (fm_to[ps] & 0xffff), owner), acc,
                     mapa(lbar, owner));
          }
          mark(kFmProducts);
          exchanged();
          mark(kFmWait);
          // owner: skip sums, the ring keeps the layer's INPUT h; the P
          // sums into the later layers' gate inputs, in layer order; the
          // next layer gated
          const float* rq = recv + lb * m.recv_each;
          const int nsr = Sn + Rn;
          // the next layer's gate inputs first, lane 2j + side for half
          // `side` of column j, in the first gw whole warps
          const int gw = rem > 0 ? (2 * Hn + 31) / 32 : 0;
          if (tid < 32 * gw) {
            const int side = tid & 1, j = tid >> 1;
            float v = 0.f;
            if (j < Hn)
              v = u[(k + 1) * 2 * Hn + side * Hn + j]
                  + rank_sum(rq + nsr + side * Hn + j, N, per);
            const float other = __shfl_xor_sync(kFull, v, 1);
            if (j < Hn && !side)
              z[((k + 1) & 1) * Hn + j] = gate<W>(v, other);
          }
          // then skip sums, the ring keeps the layer's INPUT h, and the P
          // sums into the later layers' gate inputs (layer k + 1 + q,
          // q >= 1), in layer order; the threads past the gating warps
          // first
          const int todo = nsr + (rem > 1 ? (rem - 1) * 2 * Hn : 0);
          W* slot = ring + ((size_t)p.off[l] + (t & (p.dil[l] - 1))) * Rn;
          for (int i = (tid - 32 * gw + kThreads) % kThreads; i < todo;
               i += kThreads) {
            if (i < nsr) {
              const float q = rank_sum(rq + i, N, per);
              const float b = rsb[(size_t)l * nsr + i];
              if (i < Sn) {
                skip[i] += q + b;
              } else {
                const int r = i - Sn;
                slot[r] = from_f<W>(h[r]);
                h[r] = rnd<W>(h[r] + (q + b));
              }
            } else {
              const int e = i - nsr;
              const int q = e / (2 * Hn) + 1, col = e % (2 * Hn);
              u[(k + 1 + q) * 2 * Hn + col] +=
                  rank_sum(rq + nsr + q * 2 * Hn + col, N, per);
            }
          }
          __syncthreads();
          mark(kOwnerPhase);
        }
      }
    } else {
    for (int l = 0; l < L; ++l) {
      const W* w = nullptr;   // the wide form reads tiles instead
      if constexpr (!kWide) w = stage_weights(l);
      mark(kWeights);
      W* slot = ring + ((size_t)p.off[l] + (t & (p.dil[l] - 1))) * Rn;
      // the wide form: a global layer's ring row is written to the global
      // ring, its tap-0 row read from xprev
      const W* xs = slot;
      if constexpr (kWide) {
        if (p.goff[l] >= 0) {
          slot = gring + ((size_t)row * p.grows + p.goff[l]
                          + (t & (p.dil[l] - 1))) * R + rank * Rn;
          xs = xprev + ((size_t)(t & 1) * p.n_glob + p.gidx[l]) * Rn;
        }
      }
      // tap partials: lane pair (g, tap) runs tap's chain over this rank's
      // rows (tap 0 on x[t - d], tap 1 on h), the even lane also the
      // conditioning's chain over its rows of V; the even lane adds the
      // taps and stores (taps, conditioning) into the owner of column g
      // (2G is a multiple of 32, so whole warps run each pass)
      float2* rb = reinterpret_cast<float2*>(recv);
      if constexpr (kWide) {
        // the same chains, tile by tile: the tap rows, then the
        // conditioning rows
        float acc[P], cond[P];
        #pragma unroll
        for (int ps = 0; ps < P; ++ps) acc[ps] = cond[ps] = 0.f;
        for (int r0 = 0; r0 < Rn; r0 += p.tap_rows) {
          const W* wt = tile_wait();
          const int nr = min(p.tap_rows, Rn - r0);
          #pragma unroll
          for (int ps = 0; ps < P; ++ps) {
            const int i = tid + ps * kThreads;
            if (i >= 2 * G) break;
            #pragma unroll 4
            for (int r = 0; r < nr; ++r) {
              const float x = (i & 1) ? h[r0 + r] : to_f(xs[r0 + r]);
              acc[ps] = fmaf(x, to_f(wt[(size_t)r * 2 * G + i]), acc[ps]);
            }
          }
          __syncthreads();
          tile_done();
        }
        for (int q0 = 0; q0 < Cn; q0 += p.v_rows) {
          const W* v = tile_wait();
          const int nq = min(p.v_rows, Cn - q0);
          #pragma unroll
          for (int ps = 0; ps < P; ++ps) {
            const int i = tid + ps * kThreads;
            if (i >= 2 * G) break;
            if (!(i & 1))
              for (int q = 0; q < nq; ++q)
                cond[ps] = fmaf(c[q0 + q], to_f(v[(size_t)q * G + (i >> 1)]),
                                cond[ps]);
          }
          __syncthreads();
          tile_done();
        }
        #pragma unroll
        for (int ps = 0; ps < P; ++ps) {
          const int i = tid + ps * kThreads;
          if (i >= 2 * G) break;
          const float other = __shfl_xor_sync(kFull, acc[ps], 1);
          if (!(i & 1))
            st_async(tap_dst[ps], acc[ps] + other, cond[ps], tap_bar[ps]);
        }
      } else {
      #pragma unroll
      for (int ps = 0; ps < kMaxPass; ++ps) {
        const int i = tid + ps * kThreads;
        if (i >= 2 * G) break;
        const int g = i >> 1, tap = i & 1;
        const W* wt = w + (size_t)g * 2 + tap;
        float acc = 0.f, cond = 0.f;
        if (!F::no_prev || tap) {
          #pragma unroll 8
          for (int r = 0; r < Rn; ++r) {
            const float x = tap || F::no_buf ? h[r] : to_f(slot[r]);
            acc = fmaf(x, to_f(wt[(size_t)r * 2 * G]), acc);
          }
        }
        if (!tap) {
          const W* v = w + (size_t)2 * Rn * G + g;
          if constexpr (F::no_cond) {
            // the chunk's first step's partials, kept
            if (t % p.chunk == 0) {
              #pragma unroll 8
              for (int k = 0; k < Cn; ++k)
                cond = fmaf(c[k], to_f(v[(size_t)k * G]), cond);
              ccs[l * G + g] = cond;
            } else {
              cond = ccs[l * G + g];
            }
          } else {
            #pragma unroll 8
            for (int k = 0; k < Cn; ++k)
              cond = fmaf(c[k], to_f(v[(size_t)k * G]), cond);
          }
        }
        const float other = __shfl_xor_sync(kFull, acc, 1);
        if (!tap) st_async(tap_dst[ps], acc + other, cond, tap_bar[ps]);
      }
      }
      mark(kTapProducts);
      received(0, l + 1 < L ? rs1_bytes : head_bytes);
      mark(kRs1Wait);
      // owner: sum the N partials in rank order, bias, gate
      for (int j = tid; j < Hn; j += kThreads) {
        float2 a = rb[j], b = rb[Hn + j];
        if (F::local && rank != 0) a = b = make_float2(0.f, 0.f);
        for (int k0 = 1; k0 < N; k0 += kChunk) {
          float2 av[kChunk], bv[kChunk];
          #pragma unroll
          for (int q = 0; q < kChunk; ++q) {
            const int k = k0 + q;
            av[q] = k < N ? rb[k * 2 * Hn + j] : make_float2(0.f, 0.f);
            bv[q] = k < N ? rb[k * 2 * Hn + Hn + j] : make_float2(0.f, 0.f);
            if (F::local && k != rank) av[q] = bv[q] = make_float2(0.f, 0.f);
          }
          #pragma unroll
          for (int q = 0; q < kChunk; ++q) {
            a.x += av[q].x; a.y += av[q].y; b.x += bv[q].x; b.y += bv[q].y;
          }
        }
        const float* bias = cb + (size_t)l * 2 * Hn;
        const float ua = (a.x + bias[j]) + a.y;
        const float ub = (b.x + bias[Hn + j]) + b.y;
        z[j] = gate_of<W, A>(ua, ub);
      }
      __syncthreads();
      mark(kSumGate);
      if constexpr (F::no_resskip) {
        // no product: one float to every rank keeps reduce-scatter 2's
        // place; then h += z and skip += z on this rank's own slice (R/N =
        // S/N = G/2N), the ring keeping the layer's INPUT h
        if (tid < N)
          st_async(mapa(smem_u32(recv + m.recv_each + rank), tid), 0.f,
                   mapa(bar0 + 8, tid));
        mark(kRsProducts);
        received(1, l + 1 < L ? rs2_bytes : gather_bytes);
        mark(kRs2Wait);
        for (int n = tid; n < Hn; n += kThreads) {
          skip[n] += z[n];
          slot[n] = from_f<W>(h[n]);
          h[n] = rnd<W>(h[n] + z[n]);
        }
        __syncthreads();
        mark(kOwnerUpdate);
        continue;
      }
      // skip|res partials over this rank's rows of z, into their owners
      float* rq = recv + m.recv_each;
      if constexpr (kWide) {
        // the same chains, tile by tile
        float acc[kMaxPass];
        #pragma unroll
        for (int ps = 0; ps < kMaxPass; ++ps) acc[ps] = 0.f;
        for (int j0 = 0; j0 < Hn; j0 += p.rs_rows) {
          const W* wsr = tile_wait();
          const int nj = min(p.rs_rows, Hn - j0);
          #pragma unroll
          for (int ps = 0; ps < kMaxPass; ++ps) {
            const int n = tid + ps * kThreads;
            if (n >= S + R) break;
            #pragma unroll 4
            for (int j = 0; j < nj; ++j)
              acc[ps] = fmaf(z[j0 + j], to_f(wsr[(size_t)j * (S + R) + n]),
                             acc[ps]);
          }
          __syncthreads();
          tile_done();
        }
        #pragma unroll
        for (int ps = 0; ps < kMaxPass; ++ps) {
          const int n = tid + ps * kThreads;
          if (n >= S + R) break;
          st_async(rs_dst[ps], acc[ps], rs_bar[ps]);
        }
      } else {
      const W* wsr = w + (size_t)(2 * Rn + Cn) * G;
      #pragma unroll
      for (int ps = 0; ps < kMaxPass; ++ps) {
        const int n = tid + ps * kThreads;
        if (n >= S + R) break;
        float acc = 0.f;
        #pragma unroll 8
        for (int j = 0; j < Hn; ++j)
          acc = fmaf(z[j], to_f(wsr[(size_t)j * (S + R) + n]), acc);
        st_async(rs_dst[ps], acc, rs_bar[ps]);
      }
      }
      mark(kRsProducts);
      received(1, l + 1 < L ? rs2_bytes : gather_bytes);
      mark(kRs2Wait);
      // owner: skip sums; the ring keeps the layer's INPUT h
      for (int n = tid; n < Sn + Rn; n += kThreads) {
        const float q = rsum(rq + n, Sn + Rn);
        const float b = rsb[(size_t)l * (Sn + Rn) + n];
        if (n < Sn) {
          skip[n] += q + b;
        } else {
          const int r = n - Sn;
          if (!F::no_buf) slot[r] = from_f<W>(h[r]);
          h[r] = rnd<W>(h[r] + (q + b));
        }
      }
      __syncthreads();
      mark(kOwnerUpdate);
    }
    }
    // -- head: relu -> dense -> relu -> dense, split on skip, then a1
    if constexpr (F::no_head) {
      // the probe's no_head: the head's two exchanges carry one float
      // from each rank to every rank, rank 0's the value skip[0] + skip[1]
      stage_weights(n_stages - 1);
      if (tid < N)
        st_async(mapa(smem_u32(recv + rank), tid),
                 rank == 0 ? skip[0] + skip[1] : 0.f, mapa(bar0, tid));
      received(0, rs1_bytes);
      if (tid == 0) o[0] = o[1] = recv[0];
      __syncthreads();
      if (tid < N)
        st_async(mapa(smem_u32(recv + m.recv_each + rank), tid), 0.f,
                 mapa(bar0 + 8, tid));
      received(1, rs2_bytes);
    } else {
      const W* w = stage_weights(n_stages - 1);
      if constexpr (!kFused) mark(kWeights);
      const int hb = kFused ? ex & 1 : 0;   // the reduce-scatter's buffer
      float* rq = recv + hb * m.recv_each;
      #pragma unroll
      for (int ps = 0; ps < kMaxPass; ++ps) {
        const int n = tid + ps * kThreads;
        if (n >= S) break;
        const float v = dot_chain(skip, w + n, Sn, S, ReluRound<W>());
        if constexpr (kFused) {
          const int ho = n / Sn;
          st_async(mapa(smem_u32(rq + rank * Sn + n % Sn), ho), v,
                   mapa(bar0 + 8 * hb, ho));
        } else {
          st_async(head_dst[ps], v, head_bar[ps]);
        }
      }
      mark(kHeadProducts);
      if constexpr (kFused) exchanged(); else received(0, rs1_bytes);
      mark(kHeadWaits);
      for (int n = tid; n < Sn; n += kThreads) {
        const float acc = rsum(rq + n, Sn) + h1b[n];
        a1[n] = rnd<W>(acc > 0.f ? acc : 0.f);
      }
      __syncthreads();
      mark(kHeadSums);
      // a1 @ H2 partials, gathered by every rank (local_exchange: into
      // this rank's own buffer, in each receiver's row)
      float* ro = recv + (hb ^ 1) * m.recv_each;
      const W* w2 = w + (size_t)Sn * S;
      for (int n = tid; n < O; n += kThreads) {
        const float acc = dot_chain(a1, w2 + n, Sn, O);
        const unsigned at = smem_u32(ro + rank * O + n);
        for (int d = 0; d < N; ++d) {
          if constexpr (F::local)
            st_async(mapa(smem_u32(ro + d * O + n), rank), acc,
                     mapa(bar0 + 8 * (hb ^ 1), rank));
          else
            st_async(mapa(at, d), acc, mapa(bar0 + 8 * (hb ^ 1), d));
        }
      }
      mark(kHeadProducts);
      if constexpr (kFused) exchanged(); else received(1, rs2_bytes);
      mark(kHeadWaits);
      for (int n = tid; n < O; n += kThreads) {
        o[n] = rsum(ro + n, O) + h2b[n];
      }
      __syncthreads();
      mark(kHeadSums);
      if constexpr (kWide) tile_done();   // the head's tile is read
    }
    // -- one draw per row, by warp 0 of every rank (the same draw; under
    // local_exchange each rank's own)
    if (tid < 32) {
      const float u = u_t;
      float x = 0.f;
      if (p.softmax) {
        x = (float)sample_class(o, p.Q, u, p.greedy != 0, tid);
      } else if (tid == 0) {
        const float mu = o[0];
        const float lb = F::no_head
            ? o[1] : fminf(fmaxf(o[1], p.log_b_min), p.log_b_max);
        x = mu;
        if (!F::no_sample && !p.greedy) {
          const float uu = u - 0.5f;
          const float sg = (float)((uu > 0.f) - (uu < 0.f));
          x = __fsub_rn(mu, __fmul_rn(__fmul_rn(expf(lb), sg),
                                      log1pf(-2.f * fabsf(uu))));
        }
        x = fminf(fmaxf(x, -1.f), 1.f);
      }
      if (tid == 0) {
        if (rank == 0) p.out[bt] = x;
        fb[0] = t + 1 < p.n_forced ? x_in : x;
      }
    }
    __syncthreads();
    mark(kDraw);
  }
  if constexpr (!kResident) cp_async_wait0();
  if constexpr (kTimed) {
    // the stage counts and the loop's cycles, from step 0's first read to
    // the last draw
    if (tid == 0) {
      long long* out = p.timer + ((size_t)row * N + rank) * kTimerSlots;
      #pragma unroll
      for (int k = 0; k < kTimerSlots - 1; ++k) out[k] = tk[k];
      out[kTimerSlots - 1] = (unsigned)(last - first);
    }
  }
  // no block leaves while another may still store into its shared memory
  cluster.sync();
}

// One kernel instance: storage type, weight placement, form, the probe's
// ablation and timer (production: kAblFull, untimed), and the wide form.
template <typename W, bool kResident, bool kFused, int A, bool kTimed,
          bool kWide = false>
cudaError_t prepare(size_t smem_bytes) {
  const auto kernel =
      ar_cluster_kernel<W, kResident, kFused, A, kTimed, kWide>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t launch_config(int blocks, int N, size_t smem_bytes,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// With p null, cudaOccupancyMaxActiveClusters for clusters of N blocks
// into *clusters; else the launch of p on `stream`.
template <typename W, bool kResident, bool kFused, int A, bool kTimed,
          bool kWide = false>
cudaError_t run(const Params* p, int N, size_t smem_bytes,
                cudaStream_t stream, int* clusters) {
  const auto kernel =
      ar_cluster_kernel<W, kResident, kFused, A, kTimed, kWide>;
  cudaError_t e =
      prepare<W, kResident, kFused, A, kTimed, kWide>(smem_bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  if (p == nullptr) {
    const cudaLaunchConfig_t cfg = launch_config(N, N, smem_bytes, 0, attr);
    return cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel,
                                          &cfg);
  }
  if (p->B == 0 || p->T == 0) return cudaSuccess;
  const cudaLaunchConfig_t cfg =
      launch_config(p->B * p->N, p->N, smem_bytes, stream, attr);
  e = cudaLaunchKernelEx(&cfg, kernel, *p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int A, bool kTimed, bool kFused>
cudaError_t run_of(int bf16, int resident, const Params* p, int N,
                   size_t smem_bytes, cudaStream_t s, int* clusters) {
  if (bf16)
    return resident
        ? run<__nv_bfloat16, true, kFused, A, kTimed>(p, N, smem_bytes, s,
                                                      clusters)
        : run<__nv_bfloat16, false, kFused, A, kTimed>(p, N, smem_bytes, s,
                                                       clusters);
  return resident
      ? run<float, true, kFused, A, kTimed>(p, N, smem_bytes, s, clusters)
      : run<float, false, kFused, A, kTimed>(p, N, smem_bytes, s, clusters);
}

// The instance of (bf16, resident, fused) under ablation A and timer
// kTimed; resident == kWideForm the wide form (fp32, unfused, untimed:
// `check_wide` and the probe's entry refuse the rest). The ablations are
// unfused only, the timer is on kAblFull only, and split2 has no instance
// (the probe's entry refuses them first).
template <int A, bool kTimed>
cudaError_t run_any(int bf16, int resident, int fused, const Params* p,
                    int N, size_t smem_bytes, cudaStream_t s,
                    int* clusters) {
  if constexpr (A == kSplit2 || (kTimed && A != kAblFull)) {
    return cudaErrorInvalidValue;
  } else if constexpr (A == kAblFull && !kTimed) {
    if (resident == kWideForm)
      return run<float, false, false, kAblFull, false, true>(
          p, N, smem_bytes, s, clusters);
    return fused ? run_of<A, kTimed, true>(bf16, resident, p, N,
                                           smem_bytes, s, clusters)
                 : run_of<A, kTimed, false>(bf16, resident, p, N,
                                            smem_bytes, s, clusters);
  } else if constexpr (A != kAblFull) {
    return run_of<A, false, false>(bf16, resident, p, N, smem_bytes, s,
                                   clusters);
  } else {
    return fused ? run_of<A, kTimed, true>(bf16, resident, p, N,
                                           smem_bytes, s, clusters)
                 : run_of<A, kTimed, false>(bf16, resident, p, N,
                                            smem_bytes, s, clusters);
  }
}

cudaError_t max_active_any(int bf16, int resident, int fused, int N,
                           size_t smem_bytes, int* clusters) {
  return run_any<kAblFull, false>(bf16, resident, fused, nullptr, N,
                                  smem_bytes, 0, clusters);
}

// The shape refusals shared by every entry point; W, the fused window (0:
// unfused), is clamped to L by the caller; `wide`, the wide form, takes
// kMaxPassW passes of the tap lanes.
int check_shape(int L, int R, int G, int S, int C, int N, int W,
                bool wide = false) {
  if (L < 1 || L > kMaxLayers) return kErrLayers;
  if (2 * G > (wide ? kMaxPassW : kMaxPass) * kThreads
      || S + R > kMaxPass * kThreads || C > N * kThreads)
    return kErrWidth;
  if (N < 2 || N > kMaxCluster || (N & (N - 1)) != 0 || G % 16 != 0
      || R % N != 0 || (G / 2) % N != 0 || C % N != 0 || S % N != 0)
    return kErrSplit;
  if (W < 0 || W > kMaxFused
      || (W && S + R + (W - 1) * G > kMaxPassF * kThreads))
    return kErrFused;
  return 0;
}

int window(int fused, int L) { return fused < L ? fused : L; }

// The wide form's own refusals, after check_shape's: fp32 and unfused; a
// tap row, a conditioning row, a skip|res row and the head's stage each
// within one tile; 16-byte aligned tiles and ring slices (S + R and R/N
// multiples of 4); at most kMaxTiles tiles a step.
int check_wide(int L, int R, int G, int S, int C, int O, int N, int bf16,
               int W) {
  if (bf16 || W) return kErrWide;
  const Split s = split_of(R, G, S, C, N);
  const int te = kTileBytes / 4;
  if ((S + R) % 4 || s.Rn % 4 || 2 * G > te || S + R > te
      || (s.Sn * (S + O) + 7) / 8 * 8 > te)
    return kErrWide;
  if (wide_tiles(L, R, G, S, C, O, N, 4, nullptr, nullptr) > kMaxTiles)
    return kErrWide;
  return 0;
}

// Every shape refusal of a form (resident: 0, kResidentForm or
// kWideForm).
int check_form(int L, int R, int G, int S, int C, int O, int N, int bf16,
               int resident, int W) {
  const bool wide = resident == kWideForm;
  const int e = check_shape(L, R, G, S, C, N, W, wide);
  if (e != 0 || !wide) return e;
  return check_wide(L, R, G, S, C, O, N, bf16, W);
}

// The ring rows one block keeps in shared memory (*rows) and its row keeps
// in the global ring (*grows), and the number of global layers, for a form.
void ring_rows(const int* dilations, int L, int R, int N, int elem,
               int resident, int* rows, int* grows, int* n_glob) {
  int off[kMaxLayers], goff[kMaxLayers], gidx[kMaxLayers],
      glayer[kMaxLayers];
  if (resident == kWideForm) {
    pack_rings_wide(dilations, L, R / N, elem, off, goff, gidx, glayer, rows,
                    grows, n_glob);
  } else {
    pack_rings(dilations, L, off, rows);
    *grows = *n_glob = 0;
  }
}

}  // namespace

// Bytes of shared memory one block needs for this layout: weights resident
// (resident != 0) or streamed from L2; bf16 != 0 stores weights and rings
// in bf16; fused = W > 0 the fused window. Returns a kErr* refusal on a
// shape the kernel cannot take.
extern "C" long long ar_cluster_smem_bytes(const int* dilations, int L,
                                           int R, int G, int S, int C, int O,
                                           int N, int bf16, int resident,
                                           int fused) {
  const int W = window(fused, L);
  const int e = check_form(L, R, G, S, C, O, N, bf16, resident, W);
  if (e != 0) return e;
  int rows, grows, n_glob;
  ring_rows(dilations, L, R, N, bf16 ? 2 : 4, resident, &rows, &grows,
            &n_glob);
  return (long long)smem_layout(rows, L, R, G, S, C, O, N, bf16 ? 2 : 4,
                                resident == kResidentForm, W, 0,
                                resident == kWideForm, n_glob)
      .bytes;
}

// The ring rows of one batch row of this form: those split over the
// cluster's shared memory (*shared_rows) and those in the global ring
// (*global_rows: the wide form's; the wrapper allocates B x global_rows x
// R zeros). Returns a kErr* refusal or 0.
extern "C" int ar_cluster_rings(const int* dilations, int L, int R, int G,
                                int S, int C, int O, int N, int bf16,
                                int resident, int* shared_rows,
                                int* global_rows) {
  const int e = check_form(L, R, G, S, C, O, N, bf16, resident, 0);
  if (e != 0) return e;
  int n_glob;
  ring_rows(dilations, L, R, N, bf16 ? 2 : 4, resident, shared_rows,
            global_rows, &n_glob);
  return 0;
}

// Elements of one stage of a rank's packed weights, unfused (the wrapper
// packs them at this stride).
extern "C" int ar_cluster_stage_stride(int R, int G, int S, int C, int O,
                                       int N) {
  return stage_stride(R, G, S, C, O, N);
}

// The fused window's stages of one rank (`fused_stages`): fills off and
// len (2L + 1 each: per block each layer's tap stage, then each layer's
// fm rows; then the head) and returns the elements of one rank's stages,
// or a kErr* refusal.
extern "C" int ar_cluster_fused_stages(int L, int R, int G, int S, int C,
                                       int O, int N, int fused, int* off,
                                       int* len) {
  const int W = window(fused, L);
  const int e = check_shape(L, R, G, S, C, N, W);
  if (e != 0) return e;
  if (W < 1) return kErrFused;
  return fused_stages(L, R, G, S, C, O, N, W, off, len).total;
}

// cudaOccupancyMaxActiveClusters for clusters of N blocks of this layout
// on the current device, into *clusters. Returns a kErr* refusal or the
// cudaError_t.
extern "C" int ar_cluster_max_active(const int* dilations, int L, int R,
                                     int G, int S, int C, int O, int N,
                                     int bf16, int resident, int fused,
                                     int* clusters) {
  const long long bytes = ar_cluster_smem_bytes(dilations, L, R, G, S, C, O,
                                                N, bf16, resident, fused);
  if (bytes < 0) return (int)bytes;
  *clusters = 0;
  return (int)max_active_any(bf16, resident, fused, N, (size_t)bytes,
                             clusters);
}

namespace {

// One call (see ar_cluster_generate): fills the Params, checks one block's
// shared memory (with `extra`, the probe's own floats) and that a cluster
// of N fits, then launches. dispatch(W, p, smem_bytes, stream, clusters)
// picks the instance: with p null, its occupancy into *clusters; else
// the launch of p.
template <typename Dispatch>
int launch(Dispatch dispatch, int extra, int chunk, long long* timer,
    const float* c_up, const float* noise, const float* teacher, float* out,
    const int* lengths, const int* order, const void* in_w,
    const void* in_b, const void* conv_b, const void* res_b,
    const void* skip_b, const void* h1_b, const void* h2_b,
    const void* stages, const int* dilations, int B, int T, int L, int R,
    int G, int S, int C, int Q, int O, int N,
    int softmax, int greedy, int n_forced, int bf16, int resident,
    int fused, float log_b_min, float log_b_max, void* ring, void* stream) {
  const int W = window(fused, L);
  const bool wide = resident == kWideForm;
  int e = check_form(L, R, G, S, C, O, N, bf16, resident, W);
  if (e != 0) return e;
  if (softmax && (Q % 32 != 0 || Q > 32 * kMaxPerLane)) return kErrClasses;
  Params p;
  p.c_up = c_up; p.noise = noise; p.teacher = teacher; p.out = out;
  p.in_w = in_w; p.in_b = in_b; p.conv_b = conv_b; p.res_b = res_b;
  p.skip_b = skip_b; p.h1_b = h1_b; p.h2_b = h2_b;
  p.stages = stages;
  p.B = B; p.T = T; p.L = L; p.R = R; p.G = G; p.S = S; p.C = C;
  p.Q = Q; p.O = O; p.N = N;
  p.softmax = softmax; p.greedy = greedy; p.n_forced = n_forced;
  p.fused = W;
  if (W) {
    const Stages st = fused_stages(L, R, G, S, C, O, N, W, p.soff, p.slen);
    p.stride = st.longest;
    p.total = st.total;
    // the exchanges of a step: per block, its block exchange and one per
    // layer; then the head's two; bytes each owner receives
    const Split s = split_of(R, G, S, C, N);
    int x = 0;
    for (int b0 = 0; b0 < L; b0 += W) {
      const int nb = W < L - b0 ? W : L - b0;
      p.xbytes[x++] = N * nb * 2 * s.Hn * 12;
      for (int k = 0; k < nb; ++k)
        p.xbytes[x++] = N * (s.Sn + s.Rn + (nb - 1 - k) * 2 * s.Hn) * 4;
    }
    p.xbytes[x++] = N * s.Sn * 4;
    p.xbytes[x++] = N * O * 4;
    p.n_exch = x;
  } else {
    p.stride = stage_stride(R, G, S, C, O, N);
    p.total = (L + 1) * p.stride;
    p.n_exch = 2 * L + 2;
  }
  p.log_b_min = log_b_min; p.log_b_max = log_b_max;
  p.chunk = chunk; p.timer = timer;
  for (int l = 0; l < L; ++l) p.dil[l] = dilations[l];
  p.gring = ring;
  p.grows = p.n_glob = p.n_tiles = 0;
  if (wide) {
    pack_rings_wide(dilations, L, R / N, 4, p.off, p.goff, p.gidx, p.glayer,
                    &p.rows, &p.grows, &p.n_glob);
    if (p.grows > 0 && ring == nullptr) return kErrWide;
    const Tiles t = wide_tile_rows(G, S, R, 4);
    p.tap_rows = t.tap_rows;
    p.v_rows = t.v_rows;
    p.rs_rows = t.rs_rows;
    p.n_tiles = wide_tiles(L, R, G, S, C, O, N, 4, p.toff, p.tlen);
  } else {
    pack_rings(dilations, L, p.off, &p.rows);
  }
  const size_t smem_bytes = smem_layout(p.rows, L, R, G, S, C, O, N,
                                        bf16 ? 2 : 4,
                                        resident == kResidentForm, W, extra,
                                        wide, p.n_glob)
                                .bytes;
  int device = 0, smem_max = 0;
  e = (int)cudaGetDevice(&device);
  if (e == 0)
    e = (int)cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != 0) return e;
  if (smem_bytes > (size_t)smem_max) return kErrSharedMemory;
  int clusters = 0;
  e = (int)dispatch(W, nullptr, smem_bytes, 0, &clusters);
  if (e != 0) return e;
  if (clusters < 1) return kErrOccupancy;
  // order a permutation of the rows (each once), lengths in [0, T]
  std::vector<char> seen(B, 0);
  for (int b = 0; b < B; ++b) {
    const int r = order ? order[b] : b;
    if (r < 0 || r >= B || seen[r] ||
        (lengths && (lengths[r] < 0 || lengths[r] > T)))
      return kErrRows;
    seen[r] = 1;
  }
  // kMaxRows clusters a launch, in the order given
  for (int b0 = 0; b0 < B; b0 += kMaxRows) {
    p.B = B - b0 < kMaxRows ? B - b0 : kMaxRows;
    for (int k = 0; k < p.B; ++k) {
      p.row_of[k] = order ? order[b0 + k] : b0 + k;
      p.len_of[k] = lengths ? lengths[p.row_of[k]] : T;
    }
    e = (int)dispatch(W, &p, smem_bytes, (cudaStream_t)stream, nullptr);
    if (e != 0) return e;
  }
  return 0;
}

}  // namespace

// Launch on `stream` on the current device: clusters of N blocks, one
// cluster per batch row. `stages` holds every rank's packed weight slices,
// (N, L + 1, stride) unfused (`stage_stride`), (N, total) with the fused
// window fused = W > 0 (`ar_cluster_fused_stages`), of the storage type
// (fp32, or bf16 when bf16 != 0), as are the biases and in_w/in_b (conv_b
// the fused window's folded bias when fused > 0); resident: 0
// streams the weights from L2 a stage at a time, kResidentForm keeps them
// in shared memory for the whole call, kWideForm runs the wide form, whose
// global ring `ring` is B x global_rows x R zeros (`ar_cluster_rings`;
// null elsewhere). lengths (B steps, each in
// [0, T]) and order (a permutation of the B rows, cluster k running row
// order[k]) are host arrays, or null for T steps and row k; the samples
// of a row past its length are not written.
// Returns 0, one of the kErr* refusals (checked before anything runs: too
// many layers, a class count the sampler cannot split over a warp, a
// width N does not divide or an N the kernel does not take, a fused window
// it cannot hold, a block's shared memory, no cluster of N such blocks
// fitting the card, a length out of range or an order that is no
// permutation of the rows), or the cudaError_t
// of the attribute calls or the launch.
extern "C" int ar_cluster_generate(
    const float* c_up, const float* noise, const float* teacher, float* out,
    const int* lengths, const int* order, const void* in_w,
    const void* in_b, const void* conv_b, const void* res_b,
    const void* skip_b, const void* h1_b, const void* h2_b,
    const void* stages, const int* dilations, int B, int T, int L, int R,
    int G, int S, int C, int Q, int O, int N,
    int softmax, int greedy, int n_forced, int bf16, int resident,
    int fused, float log_b_min, float log_b_max, void* ring, void* stream) {
  return launch(
      [&](int W, const Params* p, size_t smem_bytes, cudaStream_t s,
          int* clusters) {
        return run_any<kAblFull, false>(bf16, resident, W, p, N, smem_bytes,
                                        s, clusters);
      },
      0, 0, nullptr, c_up, noise, teacher, out, lengths, order, in_w, in_b,
      conv_b, res_b, skip_b, h1_b, h2_b, stages, dilations, B, T, L, R, G,
      S, C, Q, O, N, softmax, greedy, n_forced, bf16, resident, fused,
      log_b_min, log_b_max, ring, stream);
}

#ifdef AR_CLUSTER_PROBE
namespace {

template <int... A>
cudaError_t run_ablation(int ablate, int bf16, int resident, const Params* p,
                         int N, size_t smem_bytes, cudaStream_t s,
                         int* clusters, std::integer_sequence<int, A...>) {
  cudaError_t e = cudaErrorInvalidValue;
  ((ablate == A ? (e = run_any<A, false>(bf16, resident, 0, p, N, smem_bytes,
                                         s, clusters),
                   0)
                : 0),
   ...);
  return e;
}

}  // namespace

// The probe (ablate: the index of the ablation, kAblFull .. kLocalExchange;
// chunk: where no_cond refreshes its conditioning partials; timer: null,
// or (B, N, kTimerSlots) int64 for the timed instance), on the arguments
// of ar_cluster_generate. Refuses, before anything runs, what that entry
// refuses and: lengths or order (its instances run every row for T
// steps, in row order); more than kMaxRows rows (one launch: the timer's
// slots are indexed by the launch's clusters); an unknown ablation;
// split2; an ablation with the fused window, the timer, the softmax head
// or a teacher; no_resskip unless R = S = G/2; no_head with S/N < 2; an
// untimed call whose chunk is not a multiple of 4 dividing T; the wide
// form.
extern "C" int ar_cluster_probe(
    const float* c_up, const float* noise, const float* teacher, float* out,
    const int* lengths, const int* order, const void* in_w,
    const void* in_b, const void* conv_b, const void* res_b,
    const void* skip_b, const void* h1_b, const void* h2_b,
    const void* stages, const int* dilations, int B, int T, int L, int R,
    int G, int S, int C, int Q, int O, int N,
    int softmax, int greedy, int n_forced, int bf16, int resident,
    int fused, float log_b_min, float log_b_max, int ablate, int chunk,
    long long* timer, void* stream) {
  if (lengths || order || resident == kWideForm) return kErrProbeForm;
  if (B > kMaxRows) return kErrRows;
  if (ablate < 0 || ablate >= kNumAblations) return kErrAblation;
  if (ablate == kSplit2) return kErrSplit2;
  if (ablate != kAblFull && (fused || timer || softmax || n_forced))
    return kErrProbeForm;
  if (ablate == kNoResSkip && (R != G / 2 || S != G / 2)) return kErrResSkip;
  if (ablate == kNoHead && (N < 1 || S / N < 2)) return kErrHead;
  if (!timer && (chunk < 4 || chunk % 4 != 0 || T % chunk != 0))
    return kErrChunk;
  const int extra = ablate == kNoCond || ablate == kMatmulsOnly ? L * G : 0;
  return launch(
      [&](int W, const Params* p, size_t smem_bytes, cudaStream_t s,
          int* clusters) {
        if (timer)
          return run_any<kAblFull, true>(bf16, resident, W, p, N, smem_bytes,
                                         s, clusters);
        return run_ablation(ablate, bf16, resident, p, N, smem_bytes, s,
                            clusters,
                            std::make_integer_sequence<int, kNumAblations>());
      },
      extra, chunk, timer, c_up, noise, teacher, out, lengths, order, in_w,
      in_b, conv_b, res_b, skip_b, h1_b, h2_b, stages, dilations, B, T, L,
      R, G, S, C, Q, O, N, softmax, greedy, n_forced, bf16, resident, fused,
      log_b_min, log_b_max, nullptr, stream);
}
#endif  // AR_CLUSTER_PROBE

extern "C" const char* ar_cluster_error_string(int e) {
  switch (e) {
    case kErrLayers:
      return "more than 64 layers";
    case kErrClasses:
      return "softmax quantize_channels must be a multiple of 32 and <= 1024";
    case kErrSharedMemory:
      return "shared memory: one rank's ring slice, weights and scratch "
             "exceed a block's shared memory; stream the weights from L2 "
             "or use a larger cluster";
    case kErrSplit:
      return "cluster size must be 2, 4, 8 or 16 and divide "
             "residual_channels, gate_channels / 2, cond_channels and "
             "skip_channels; gate_channels must be a multiple of 16";
    case kErrWidth:
      return "gate_channels must be <= 512 (1024 in the wide form), "
             "skip_channels + residual_channels <= 1024 and cond_channels "
             "<= 256 x the cluster size";
    case kErrWide:
      return "the wide form runs fp32 and unfused, with a tap row (2 x "
             "gate_channels), skip_channels + residual_channels and the "
             "head's rows of one rank within 32 KB, skip_channels + "
             "residual_channels and residual_channels / N multiples of 4, "
             "at most 1024 weight tiles a step, and a global ring";
    case kErrOccupancy:
      return "occupancy: no cluster of this many blocks with this shared "
             "memory fits the card";
    case kErrFused:
      return "fused window: W must be <= 16 and skip_channels + "
             "residual_channels + (W - 1) x gate_channels <= 2048";
    case kErrAblation:
      return "unknown ablation";
    case kErrSplit2:
      return "split2 is refused on the cluster kernel: two rows per "
             "cluster change the production layout (ROADMAP Queue B, "
             "several rows per cluster)";
    case kErrResSkip:
      return "no_resskip on the cluster kernel adds each rank's own z slice "
             "to its h and skip slices: it needs R = S = G/2";
    case kErrHead:
      return "no_head sums skip[0] + skip[1] on rank 0: it needs "
             "skip_channels / N >= 2";
    case kErrChunk:
      return "chunk must be a positive multiple of 4 that divides T";
    case kErrRows:
      return "lengths must lie in [0, T], order hold each row of [0, B) "
             "once, and the probe take at most 512 rows";
    case kErrProbeForm:
      return "the ablations run on the unfused form of the Laplace head, "
             "untimed and without a teacher; the timer on full only; the "
             "probe takes no lengths or order";
  }
  return cudaGetErrorString((cudaError_t)e);
}
