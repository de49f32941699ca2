"""The AR step's ablation probe: the wrappers around `csrc/ar_probe.cu` (on
ar_generate's body) and `csrc/ar_cluster.cu`'s probe instances (on the
cluster kernel), their plain PyTorch version, and the cluster kernel's
per-stage timer — the counterpart of the TPU probe `tools/kprobe.py`.

The probe runs the unfused AR step with one part stripped out
(`ABLATIONS`, the TPU probe's list and order), so that the time each part
costs can be read off against `full`. Every ablation is a well-defined
function, but only `full` and the schedules of it (`SCHEDULES`) compute
the vocoder's step. The probe's model is the TPU probe's: a Laplace head
with the log-scale clip `LOG_B_CLIP`, the input encoded as x + in_b (unit
input weights), and no biases. `full` is the production kernel's function
on such weights (`plain_params`), and on the card its kernel is the
production body, so it equals the production launch to the bit there.

Two kernels (`KERNELS`): "generate", `csrc/ar_probe.cu`, a copy of
ar_generate.cu's body (one SM per row), and "cluster", the production
source `csrc/ar_cluster.cu` built with its ablations and timer as template
parameters into the library `ar_cluster_probe`: clusters of `split` = N
SMs per row, the weights packed by `ar_kernel.pack_cluster` and placed as
the decode places them (`ar_kernel.cluster_size`, `cluster_resident`;
callers may pass both). The cluster kernel takes `CLUSTER_ABLATIONS`:
ABLATIONS without split2 (two rows per cluster would change the
production layout), plus its own `local_exchange` (every exchange into
the sender's own buffer; each owned column sums only the owner's own
partial). Its sums run in its own order: the plain version's `split=N,
chain=True` (`ar_kernel.split_sum`).

Layouts are the TPU probe's: conditioning (T, B, C) fp32, uniforms (T, B),
samples out (T, B). The weights are a dict (`WEIGHTS`) of fp32 or bf16
tensors, made by `probe_weights` (the TPU probe's recipe) or carried from
the TPU probe's seven arrays by `weights_from_jax`. The TPU probe pads the
gate halves to its 128-lane tile (gp = 128); the port uses the production
geometry gp = G/2, so the two agree where G = 256.

On a CUDA tensor `probe` launches the kernel (one launch per call; the
time loop runs inside it) or raises; on a CPU tensor it runs the plain
version, `probe_plain`, which repeats the kernel's arithmetic (rounding to
bf16 where the kernel does) with matmuls that sum in their own order, or
(`chain=True`) in the kernel's.
`check_shape` raises, on both versions, on what an ablation cannot take:
`no_resskip` adds z[:R] and z[:S], so it needs R, S <= G/2 (undefined at
config 2, where S = 128 > G/2 = 64), and on the cluster kernel R = S = G/2
(each rank's z slice is then its h and skip slice); `split2` runs two rows
per block, so it needs an even batch, and is refused on the cluster
kernel; `no_head` on the cluster kernel needs S/N >= 2; `chunk` (a
multiple of 4, for the unrolled loops) must divide T. The kernels' C
entries refuse the same, and a config whose resident rings do not fit
one block's shared memory.

The timer (`timed_generate`): the cluster kernel's production instance
with a clock read at each stage boundary, at any of the decode's layouts;
`stage_times` turns its (B, N, 12) cycle counts into us per step per
stage kind. It is the production step in one respect older: cluster k
runs row k for T steps, where the production instance reads each
cluster's row and steps from the launch (per-row lengths, longest rows
first), so its stage table is of that in-order, padded form (TIMED_FORM);
on a call without lengths its samples are the production launch's.
`launches` counts kernel launches by variant.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.config import ModelConfig
from shallow_wavenet_tpu_torch.ops import _build, ar_kernel
from shallow_wavenet_tpu_torch.ops.ar_kernel import DTYPES, check_supported

ABLATIONS = ("full", "no_cond", "no_prev", "no_buf", "no_resskip",
             "no_head", "no_sample", "matmuls_only", "cheap_gate",
             "no_gate", "unroll2", "unroll4", "split2", "gate_bf16")
# other schedules of full's own function
SCHEDULES = ("unroll2", "unroll4", "split2")
KERNELS = ("generate", "cluster")
# the cluster kernel's: no split2, and its own local_exchange
CLUSTER_ABLATIONS = tuple(a for a in ABLATIONS if a != "split2") + (
    "local_exchange",)
# the C entries' ablation index (csrc/ar_cluster.cu `Ablation`)
ALL_ABLATIONS = ABLATIONS + ("local_exchange",)
LOG_B_CLIP = (-9.0, 3.0)
WEIGHTS = ("in_b", "conv_w", "cond_w", "res_w", "skip_w", "h1_w", "h2_w")
# the timer's stage kinds (csrc/ar_cluster.cu `StageKind`): {name: slot},
# unfused and fused; slot TIMER_SLOTS - 1 holds the time loop's cycles
STAGES = {
    False: {n: i for i, n in enumerate((
        "weights", "tap+cond products", "rs1 wait", "sum+gate",
        "skip|res products", "rs2 wait", "skip/res+ring", "head products",
        "head waits", "head sums", "draw"))},
    True: {**{n: i for i, n in enumerate((
        "block products", "block wait", "block gate", "fm products",
        "fm wait", "owner phase"))},
        "head products": 7, "head waits": 8, "head sums": 9, "draw": 10},
}
TIMER_SLOTS = 12
# the timed instance's form, where it differs from production's
TIMED_FORM = ("row k on cluster k, T steps each (production: each "
              "cluster's row and steps from the launch)")

# kernel launches by variant (`variant`) since the last reset; callers
# clear it to count a run
launches: collections.Counter = collections.Counter()


def variant(dtype: str, ablate: str, kernel: str = "generate",
            split: int = 0, resident: bool = True, fused: int = 0) -> str:
    """The kernel variant's name, as `launches` counts it: `ar_probe[...]`
    on ar_generate's body, or on the cluster kernel
    `ar_cluster_probe[bf16,N8,l2,no_cond]` (`l2`: weights streamed from L2;
    ablate "timed" for the timer, `ar_cluster_probe[fused4,N8,l2,timed]`)."""
    if kernel == "generate":
        return f"ar_probe[{'bf16,' if dtype == 'bfloat16' else ''}{ablate}]"
    tags = [t for t, on in (("bf16", dtype == "bfloat16"),
                            (f"fused{fused}", fused > 0),
                            (f"N{split}", True), ("l2", not resident),
                            (ablate, True)) if on]
    return f"ar_cluster_probe[{','.join(tags)}]"


def _weight_shapes(cfg: ModelConfig) -> dict:
    L, R, G = len(cfg.dilations), cfg.residual_channels, cfg.gate_channels
    S, C = cfg.skip_channels, cfg.cond_channels
    return {"in_b": (R,), "conv_w": (L, 2, R, G), "cond_w": (L, C, G),
            "res_w": (L, G // 2, R), "skip_w": (L, G // 2, S),
            "h1_w": (S, S), "h2_w": (S, 2)}


def _port_layout(in_b, conv_w, cond_wcat, res_w, skip_w, h1, h2) -> dict:
    L, _, _, G = conv_w.shape
    C = cond_wcat.shape[0]
    cond_w = cond_wcat.reshape(C, L, G).permute(1, 0, 2).contiguous()
    return dict(zip(WEIGHTS, (in_b, conv_w, cond_w, res_w, skip_w, h1, h2)))


def weights_from_jax(arrays) -> dict:
    """The TPU probe's seven weight arrays (`tools/kprobe.py:221-222`:
    in_b (R), conv_w (L, 2, R, 2gp), cond_wcat (C, L * 2gp), res_w (L, gp,
    R), skip_w (L, gp, S), h1 (S, S), h2 (S, 2); numpy or JAX arrays, fp32
    or bf16) in the port's layout: the same values and dtype, cond_wcat as
    cond_w (L, C, G), CPU tensors. gp must be G/2 (the port has no lane
    padding)."""
    def tensor(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return torch.from_numpy(a.copy())
        if a.dtype.name == "bfloat16":      # exact through fp32
            return torch.from_numpy(a.astype(np.float32)).bfloat16()
        raise ValueError(f"probe weights must be float32 or bfloat16, got "
                         f"{a.dtype}")
    return _port_layout(*(tensor(a) for a in arrays))


def probe_weights(cfg: ModelConfig, dtype: str = "float32",
                  seed: int = 0) -> dict:
    """The TPU probe's weights (`tools/kprobe.py:215-222`): normal with std
    0.05 from `np.random.default_rng(seed)`, drawn in its order and shapes
    (with gp = G/2), cast to `dtype`, in the port's layout on the CPU."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                         f"{dtype!r}")
    rng = np.random.default_rng(seed)
    L, R, G = len(cfg.dilations), cfg.residual_channels, cfg.gate_channels
    S, C, gp = cfg.skip_channels, cfg.cond_channels, cfg.gate_channels // 2

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape) * 0.05).to(
            DTYPES[dtype])

    return _port_layout(mk(R), mk(L, 2, R, G), mk(C, L * G), mk(L, gp, R),
                        mk(L, gp, S), mk(S, S), mk(S, 2))


def plain_params(weights: dict) -> dict:
    """The probe's weights as the production kernel's plain params
    (`ops.ar_kernel`, Laplace head), fp32 on their device: unit input
    weights and zero biases, as the TPU timing prototypes build them. On
    these `full` is `ar_kernel.generate`'s function."""
    w = {k: v.float() for k, v in weights.items()}
    L, _, R, G = w["conv_w"].shape
    S = w["h1_w"].shape[0]
    dev = w["conv_w"].device

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    return {"input_w": torch.ones(1, R, device=dev), "input_b": w["in_b"],
            "conv_w": w["conv_w"], "conv_b": zeros(L, G),
            "cond_w": w["cond_w"], "res_w": w["res_w"], "res_b": zeros(L, R),
            "skip_w": w["skip_w"], "skip_b": zeros(L, S),
            "head1_w": w["h1_w"], "head1_b": zeros(S), "head2_w": w["h2_w"],
            "head2_b": zeros(2)}


def check_shape(cfg: ModelConfig, ablate: str, B: int, T: int,
                chunk: int, kernel: str = "generate", split: int = 0
                ) -> None:
    """Raise ValueError where ablation `ablate` is undefined on `kernel`
    (the cluster kernel at `split` = N ranks; see the module docstring);
    the kernels' C entries refuse the same."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    known = ABLATIONS if kernel == "generate" else CLUSTER_ABLATIONS
    if kernel == "cluster" and ablate == "split2":
        raise ValueError(
            "split2 is refused on the cluster kernel: two rows per cluster "
            "change the production layout (ROADMAP Queue B, several rows "
            "per cluster)")
    if ablate not in known:
        raise ValueError(f"unknown ablation {ablate!r}; one of {known}")
    check_supported(cfg)
    half = cfg.gate_channels // 2
    if ablate == "no_resskip" and (cfg.residual_channels > half
                                   or cfg.skip_channels > half):
        raise ValueError(
            f"no_resskip adds z[:R] and z[:S]: it needs R <= G/2 and S <= "
            f"G/2, got R={cfg.residual_channels}, S={cfg.skip_channels}, "
            f"G/2={half}")
    if ablate == "split2" and B % 2:
        raise ValueError(f"split2 runs two batch rows per block: it needs "
                         f"an even batch, got B={B}")
    if chunk < 4 or chunk % 4 or T % chunk:
        raise ValueError(f"chunk must be a positive multiple of 4 that "
                         f"divides T, got chunk={chunk}, T={T}")
    if kernel == "generate":
        return
    if cfg.head != "laplace":
        raise ValueError("the probe's model has a Laplace head, got "
                         f"{cfg.head!r}")
    ar_kernel.cluster_partition(cfg, split)
    if ablate == "no_resskip" and not (cfg.residual_channels
                                       == cfg.skip_channels == half):
        raise ValueError(
            f"no_resskip on the cluster kernel adds each rank's own z "
            f"slice to its h and skip slices: it needs R = S = G/2, got "
            f"R={cfg.residual_channels}, S={cfg.skip_channels}, G/2={half}")
    if ablate == "no_head" and cfg.skip_channels // split < 2:
        raise ValueError(f"no_head sums skip[0] + skip[1] on rank 0: it "
                         f"needs skip_channels / N >= 2, got "
                         f"S={cfg.skip_channels}, N={split}")


def _prepare(weights, cfg, cond, noise, ablate, chunk, dev,
             kernel="generate", split=0):
    cond = torch.as_tensor(cond, dtype=torch.float32).to(dev).contiguous()
    if cond.ndim != 3 or cond.shape[2] != cfg.cond_channels:
        raise ValueError(f"cond must be (T, B, {cfg.cond_channels}), got "
                         f"{tuple(cond.shape)}")
    T, B, _ = cond.shape
    noise = torch.as_tensor(noise, dtype=torch.float32).to(dev).contiguous()
    if tuple(noise.shape) != (T, B):
        raise ValueError(f"noise must be (T, B) = ({T}, {B}), got "
                         f"{tuple(noise.shape)}")
    check_shape(cfg, ablate, B, T, chunk, kernel, split)
    if set(weights) != set(WEIGHTS):
        raise ValueError(f"probe weights are {WEIGHTS}, got {sorted(weights)}")
    dtypes = {weights[k].dtype for k in WEIGHTS}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPES.values():
        raise ValueError(f"probe weights must share one dtype of "
                         f"{sorted(DTYPES)}, got {dtypes}")
    for k, shape in _weight_shapes(cfg).items():
        if tuple(weights[k].shape) != shape:
            raise ValueError(f"{k} must be {shape} for this config, got "
                             f"{tuple(weights[k].shape)}")
    w = {k: weights[k].to(dev).contiguous() for k in WEIGHTS}
    return cond, noise, w


def _dtype_of(weights: dict) -> str:
    return next(k for k, v in DTYPES.items()
                if v == weights["conv_w"].dtype)


def cluster_layout(cfg: ModelConfig, dtype: str, device=None, split=None,
                   weights_l2=None) -> tuple[int, bool]:
    """(N, weights resident in shared memory) of the cluster probe: as the
    decode picks them (`ar_kernel.cluster_size`, `cluster_resident`) where
    not given. Raises ValueError on an N the kernel does not take."""
    dev = resolve_device(device)
    n = ar_kernel.cluster_size(cfg, dtype, dev) if split is None else split
    ar_kernel.cluster_partition(cfg, n)
    if n not in ar_kernel.cluster_sizes(cfg):
        raise ValueError(
            f"the cluster kernel takes N in {ar_kernel.cluster_sizes(cfg)} "
            f"for this config, got {n}")
    if weights_l2 is None:
        weights_l2 = (dev.type == "cuda"
                      and not ar_kernel.cluster_resident(cfg, dtype, n, dev))
    return n, not weights_l2


def cluster_weights(weights: dict, cfg: ModelConfig, split: int,
                    device=None) -> ar_kernel.KernelWeights:
    """The probe's weights as the cluster kernel reads them, packed for N =
    split ranks (`plain_params`, then `ar_kernel.kernel_weights`): made
    once, passed to `probe(..., packed=)` by a caller that makes many
    calls."""
    return ar_kernel.kernel_weights(plain_params(weights), cfg,
                                    _dtype_of(weights), 0, device, split)


def probe(weights: dict, cfg: ModelConfig, cond, noise, ablate: str,
          chunk: int = 128, device=None, kernel: str = "generate",
          split=None, weights_l2=None, packed=None):
    """Samples (T, B) fp32 of ablation `ablate` on `device` (None: CUDA;
    "cpu" runs `probe_plain`). cond (T, B, C) fp32, noise (T, B) uniforms
    in (0, 1); weights as `probe_weights` makes them, fp32 or bf16 (the
    kernel's storage type); `chunk` sets where no_cond refreshes its
    conditioning (the TPU probe's grid chunk). kernel: "generate"
    (`ar_probe.cu`) or "cluster" (`ar_cluster.cu`'s probe instances) at
    `split` = N ranks with the weights from L2 (`weights_l2`), each as the
    decode picks it where None (`cluster_layout`); packed: the
    `cluster_weights` of these weights for N, made once by the caller."""
    dev = resolve_device(device)
    n = resident = 0
    if kernel == "cluster":
        n, resident = cluster_layout(cfg, _dtype_of(weights), dev, split,
                                     weights_l2)
    cond, noise, w = _prepare(weights, cfg, cond, noise, ablate, chunk, dev,
                              kernel, n)
    if not cond.is_cuda:
        return _plain(cfg, cond, noise, w, ablate, chunk, None, False, n)
    if kernel == "generate":
        return _launch(cfg, cond, noise, w, ablate, chunk)
    if packed is None:
        packed = cluster_weights(w, cfg, n, dev)
    return _launch_cluster(cfg, cond, noise, packed, ablate, chunk, n,
                           resident)


def probe_plain(weights: dict, cfg: ModelConfig, cond, noise, ablate: str,
                chunk: int = 128, device=None, feedback=None,
                chain: bool = False, split: int = 0):
    """The plain PyTorch version of `probe`, on any device. The schedules
    (`SCHEDULES`) compute `full`.

    feedback: optional (B, T); step t's input is feedback[:, t] (the
    previous sample, 0.0 at t = 0) instead of the version's own last
    sample, so the version can be held against a kernel given that
    kernel's own samples. Forced so, no step waits for another, and the
    version runs the whole call at once, layer by layer (a ring's read at t
    is the layer's input at t - d); without it, one Python step per sample.

    chain: sum every dot as one fp32 chain in k order, the kernel's order,
    instead of matmuls that sum in their own. In bf16 every product (of two
    bf16 values) is exact in fp32, so this is the bf16 kernel's arithmetic
    operation for operation: on a card it meets the kernel to the bit
    wherever torch's tanh, exp and log1p give the kernel's values. Slow on
    the CPU (one op per k); on CUDA one cumsum per dot.

    split: N > 0 is the cluster kernel's probe at N ranks (its ablations,
    `CLUSTER_ABLATIONS`), with `chain` in its order, as
    `ar_kernel.generate_plain(split=N, chain=True)`: every dot as N chains,
    one over each rank's slice of k (`ar_kernel.cluster_partition`), then
    the N partials in rank order (`ar_kernel.split_sum`); so split=1 is
    chain=True's order. Without `chain`, split changes nothing but
    local_exchange's function (each output its owner's partial)."""
    dev = resolve_device(device)
    kernel = "cluster" if split else "generate"
    cond, noise, w = _prepare(weights, cfg, cond, noise, ablate, chunk, dev,
                              kernel, split)
    if feedback is not None:
        feedback = torch.as_tensor(feedback, dtype=torch.float32).to(dev)
        if tuple(feedback.shape) != tuple(noise.shape[::-1]):
            raise ValueError(f"feedback must be (B, T) = "
                             f"{tuple(noise.shape[::-1])}, got "
                             f"{tuple(feedback.shape)}")
    return _plain(cfg, cond, noise, w, ablate, chunk, feedback, chain, split)


def _sigmoid(x):
    # 1 / (1 + exp(-x)), each op at x's dtype: the kernel's sigmoid in
    # fp32, and XLA's bf16 sigmoid (gate_bf16)
    return torch.reciprocal(torch.exp(-x) + 1)


# elements of one product block in chain mode (256 MB in fp32)
_CHAIN_BLOCK = 1 << 26


def _dots(chain: bool, *pairs):
    """[x @ m for (x, m) in pairs], all of one k length. In `chain` mode
    each output is one fp32 chain in k order, from 0, as the kernel's
    dot_cols: the products are formed, then summed along k, a block of rows
    at a time."""
    if not chain:
        return [x @ m for x, m in pairs]
    widths = [m.shape[1] for _, m in pairs]
    M, K = pairs[0][0].shape
    rows = max(1, _CHAIN_BLOCK // (K * sum(widths)))
    accs = []
    for i in range(0, M, rows):
        p = torch.cat([x[i:i + rows, :, None] * m for x, m in pairs], dim=-1)
        if p.is_cuda:
            # ATen's CUDA cumsum over a dim that is not the innermost gives
            # each output one thread that adds in k order in fp32, from 0
            accs.append(p.cumsum(1)[:, -1])
        else:
            # the CPU's cumsum accumulates in double: add step by step
            acc = torch.zeros_like(p[:, 0])
            for k in range(K):
                acc += p[:, k]
            accs.append(acc)
    return torch.cat(accs).split(widths, dim=-1)


def _sum_dots(pairs, chain, split=0, owners=None):
    """The sum of the pairs' products, x0 @ m0 + x1 @ m1 + ...: with split
    = 0 in ar_generate's order (`_dots`, then the pairs in order); else the
    cluster kernel's (`ar_kernel.split_sum`, a block of rows at a time;
    owners: local_exchange's rank of each output)."""
    if not split:
        out = _dots(chain, *pairs)
        acc = out[0]
        for o in out[1:]:
            acc = acc + o
        return acc
    M, K = pairs[0][0].shape
    rows = max(1, _CHAIN_BLOCK // (K * pairs[0][1].shape[1] * len(pairs)))
    return torch.cat([
        ar_kernel.split_sum([(x[i:i + rows], m) for x, m in pairs], split,
                            chain, owners)
        for i in range(0, M, rows)])


def _owners(cfg, split):
    """local_exchange's owner rank of each output of each dot at `split`
    ranks (`ar_kernel.cluster_partition`): gate columns (taps; the
    conditioning, per layer), skip|res outputs, head1 outputs (a1); head2's
    on rank 0, whose draw is the output."""
    part = ar_kernel.cluster_partition(cfg, split)

    def of(blocks, width):
        o = torch.empty(width, dtype=torch.long)
        for k, b in enumerate(blocks):
            o[list(b)] = k
        return o

    gate = of(part["gate"], cfg.gate_channels)
    skip = of(part["skip"], cfg.skip_channels)
    return {"gate": gate, "cond": gate.repeat(len(cfg.dilations)),
            "rs": torch.cat([skip, of(part["h"], cfg.residual_channels)]),
            "head1": skip, "head2": torch.zeros(2, dtype=torch.long)}


@torch.no_grad()
def _plain(cfg, cond, noise, w, ablate, chunk, feedback, chain, split=0):
    T, B, C = cond.shape
    dil = cfg.dilations
    L, R, G = len(dil), cfg.residual_channels, cfg.gate_channels
    offs = [sum(dil[:l]) for l in range(L)]
    dev = cond.device
    wdt = w["conv_w"].dtype
    # bf16 values held in fp32: their products are exact, so fp32 matmuls
    # are the kernel's bf16 dots with fp32 sums (in another order)
    w = {k: v.float() for k, v in w.items()}
    w["cond_wcat"] = w["cond_w"].permute(1, 0, 2).reshape(C, L * G)
    w["rs_w"] = torch.cat([w["skip_w"], w["res_w"]], dim=-1)  # (L, G/2, S+R)
    owners = _owners(cfg, split) if ablate == "local_exchange" else {}

    def dot(what, *pairs):
        return _sum_dots(pairs, chain, split, owners.get(what))

    def rnd(x):
        return _round(x, wdt)

    def encode(x_in):
        return rnd(rnd(x_in)[:, None] + w["in_b"][None, :])

    no_cond = ablate in ("no_cond", "matmuls_only")
    if feedback is not None:
        # every step at once: rows are (t, b), t-major
        frames = (torch.arange(T, device=dev) // chunk * chunk if no_cond
                  else slice(None))
        cc = dot("cond", (rnd(cond[frames]).reshape(T * B, C),
                          w["cond_wcat"]))

        def tap0(l, h):
            d = min(dil[l], T)
            hv = h.view(T, B, R)
            return torch.cat([torch.zeros_like(hv[:d]), hv[:T - d]]).view(
                T * B, R)

        x = _rows(cfg, w, wdt, ablate, dot, encode(
            feedback.t().reshape(T * B)), cc, noise.reshape(T * B), tap0)
        return x.view(T, B)

    rings = torch.zeros(sum(dil), B, R, device=dev)
    fb = torch.zeros(B, device=dev)
    out = torch.empty(T, B, device=dev)
    for t in range(T):
        if not no_cond or t % chunk == 0:
            cc = dot("cond", (rnd(cond[t]), w["cond_wcat"]))

        def tap0(l, h):
            slot = offs[l] + (t & (dil[l] - 1))
            prev = rings[slot].clone()
            rings[slot] = h
            return prev

        fb = out[t] = _rows(cfg, w, wdt, ablate, dot, encode(fb), cc,
                            noise[t], tap0)
    return out


def _round(x, wdt):
    # x as the kernel stores it in wdt (fp32 values out)
    return x.to(wdt).float()


def _rows(cfg, w, wdt, ablate, dot, h, cc, noise, tap0):
    """Samples of the rows h (N, R) (encoded inputs), cc (N, L*G)
    (conditioning terms) and noise (N,): the layers, the head and the
    draw, rounding to the storage type wdt where the kernel does; tap0(l,
    h) gives layer l's tap-0 input for its input h; dot(what, *pairs) sums
    the pairs' products in the kernel's order."""
    L, R, G = len(cfg.dilations), cfg.residual_channels, cfg.gate_channels
    S, half = cfg.skip_channels, G // 2
    no_buf = ablate in ("no_buf", "matmuls_only")
    no_sample = ablate in ("no_sample", "matmuls_only")

    def rnd(x):
        return _round(x, wdt)

    def gate(ua, ub):
        if ablate == "no_gate":
            return rnd(ua)
        if ablate == "cheap_gate":
            return rnd(ua * ub)
        if ablate == "gate_bf16":
            return (torch.tanh(ua.to(wdt)) * _sigmoid(ub.to(wdt))).float()
        return rnd(torch.tanh(ua) * _sigmoid(ub))

    skip = torch.zeros(h.shape[0], S, device=h.device)
    for l in range(L):
        ccl = cc[:, l * G:(l + 1) * G]
        if ablate == "no_prev":
            u = dot("gate", (h, w["conv_w"][l, 1])) + ccl
        else:
            prev = h if no_buf else tap0(l, h)
            u = dot("gate", (prev, w["conv_w"][l, 0]),
                    (h, w["conv_w"][l, 1])) + ccl
        z = gate(u[:, :half], u[:, half:])
        if ablate == "no_resskip":
            h = rnd(h + z[:, :R])
            skip = skip + z[:, :S]
        else:
            rs = dot("rs", (z, w["rs_w"][l]))
            h = rnd(h + rs[:, S:])
            skip = skip + rs[:, :S]
    if ablate == "no_head":
        mu = log_b = skip[:, 0] + skip[:, 1]
    else:
        o = dot("head1", (rnd(torch.relu(skip)), w["h1_w"]))
        o = dot("head2", (rnd(torch.relu(o)), w["h2_w"]))
        mu, log_b = o[:, 0], torch.clamp(o[:, 1], *LOG_B_CLIP)
    if no_sample:
        x = mu
    else:
        u_t = noise - 0.5
        x = mu - torch.exp(log_b) * torch.sign(u_t) * torch.log1p(
            -2.0 * torch.abs(u_t))
    return torch.clamp(x, -1.0, 1.0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ar_probe")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ar_probe.argtypes = ([ptr] * 10 + [ctypes.POINTER(i32)] + [i32] * 10
                             + [f32, f32, ptr])
    lib.ar_probe.restype = i32
    lib.ar_probe_error_string.argtypes = [i32]
    lib.ar_probe_error_string.restype = ctypes.c_char_p
    return lib


def _launch(cfg, cond, noise, w, ablate, chunk):
    lib = _lib()
    T, B, C = cond.shape
    L = len(cfg.dilations)
    out = torch.empty((T, B), dtype=torch.float32, device=cond.device)
    bf16 = w["conv_w"].dtype == torch.bfloat16
    with torch.cuda.device(cond.device):
        err = lib.ar_probe(
            cond.data_ptr(), noise.data_ptr(), out.data_ptr(),
            *(w[k].data_ptr() for k in WEIGHTS),
            (ctypes.c_int * L)(*cfg.dilations), B, T, L,
            cfg.residual_channels, cfg.gate_channels, cfg.skip_channels, C,
            chunk, int(bf16), ABLATIONS.index(ablate), *LOG_B_CLIP,
            torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise ValueError("config not supported by the probe kernel: "
                         + lib.ar_probe_error_string(err).decode())
    if err != 0:
        raise RuntimeError("ar_probe launch failed: "
                           + lib.ar_probe_error_string(err).decode())
    launches[variant("bfloat16" if bf16 else "float32", ablate)] += 1
    return out


def _cluster_probe_lib() -> ctypes.CDLL:
    lib = _build.load("ar_cluster_probe")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ar_cluster_probe.argtypes = (
        [ptr] * 4 + [ctypes.POINTER(i32)] * 2 + [ptr] * 8
        + [ctypes.POINTER(i32)] + [i32] * 16 + [f32, f32]
        + [i32, i32, ptr, ptr])
    lib.ar_cluster_probe.restype = i32
    lib.ar_cluster_error_string.argtypes = [i32]
    lib.ar_cluster_error_string.restype = ctypes.c_char_p
    return lib


def _cluster_probe_call(args, ablate: str, chunk: int, timer, dev) -> None:
    lib = _cluster_probe_lib()
    with torch.cuda.device(dev):
        err = lib.ar_cluster_probe(
            *args, ALL_ABLATIONS.index(ablate), chunk,
            None if timer is None else timer.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise ValueError("config not supported by the cluster probe: "
                         + lib.ar_cluster_error_string(err).decode())
    if err != 0:
        raise RuntimeError("ar_cluster_probe launch failed: "
                           + lib.ar_cluster_error_string(err).decode())


def _launch_cluster(cfg, cond, noise, packed, ablate, chunk, n, resident):
    dtype = packed.dtype
    if (packed.fused, packed.cluster) != (0, n) or any(
            v.device != cond.device for v in packed.tensors.values()):
        raise ValueError(f"packed weights are for fused={packed.fused}, "
                         f"cluster={packed.cluster}; the call asks for the "
                         f"unfused form at N={n} on {cond.device}")
    args, out = ar_kernel.cluster_arguments(
        cfg, False, cond.transpose(0, 1).contiguous(),
        noise.t().contiguous(), None, 0, packed.tensors, dtype, n, resident,
        0, LOG_B_CLIP)
    _cluster_probe_call(args, ablate, chunk, None, cond.device)
    launches[variant(dtype, ablate, "cluster", n, resident)] += 1
    return out.t()


def timed_arguments(pp, cfg: ModelConfig, c_up, noise, dtype="float32",
                    fused: int = 0, cluster=None, weights_l2=None,
                    device=None):
    """What a timed call needs, made once: (args, out, timer, (dtype, N,
    resident, fused)), args the cluster kernel's C arguments
    (`ar_kernel.cluster_arguments`) writing the (B, T) samples into out,
    timer the (B, N, TIMER_SLOTS) int64 buffer. `launch_timed` launches
    the timed instance on them; `ar_kernel.launch_cluster` the production
    one on the same args. pp: plain params or their `KernelWeights` for
    this dtype, window and N; cluster and weights_l2 as the decode picks
    them where None. Needs CUDA."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the timer runs on the card; it needs CUDA")
    n = ar_kernel.cluster_size(cfg, dtype, dev, fused) if cluster is None \
        else cluster
    if weights_l2 is None:
        weights_l2 = not ar_kernel.cluster_resident(cfg, dtype, n, dev,
                                                    fused)
    c_up, noise, teacher, n_forced, w = ar_kernel._prepare(
        pp, cfg, c_up, noise, "sample", None, 0, None, 1, dev, 64, fused,
        dtype, n)
    timer = torch.zeros((c_up.shape[0], n, TIMER_SLOTS), dtype=torch.int64,
                        device=dev)
    args, out = ar_kernel.cluster_arguments(
        cfg, False, c_up, noise, teacher, n_forced, w, dtype, n,
        not weights_l2, fused)
    return args, out, timer, (dtype, n, not weights_l2, fused)


def launch_timed(args, timer, layout) -> None:
    """One launch of the timed instance (the production step in
    TIMED_FORM) on `timed_arguments`' args, its cycles into `timer`,
    counted in `launches`."""
    dtype, n, resident, fused = layout
    _cluster_probe_call(args, "full", 0, timer, timer.device)
    launches[variant(dtype, "timed", "cluster", n, resident, fused)] += 1


def timed_generate(pp, cfg: ModelConfig, c_up, noise, dtype="float32",
                   fused: int = 0, cluster=None, weights_l2=None,
                   device=None):
    """`ar_kernel.generate(pp, cfg, c_up, noise=noise, dtype=, fused=,
    cluster=)` on the cluster kernel's timed instance: returns its (B, T)
    samples (the production instance's, to the bit) and the timer's (B, N,
    TIMER_SLOTS) int64 cycles (`stage_times`); arguments as
    `timed_arguments`. The counters are 32-bit: a call's time loop must
    stay below 2^32 cycles (about 2 s on an H100)."""
    args, out, timer, layout = timed_arguments(
        pp, cfg, c_up, noise, dtype, fused, cluster, weights_l2, device)
    launch_timed(args, timer, layout)
    return ar_kernel._finish(cfg, out), timer


def stage_times(buffer, event_ms: float, T: int, fused: int) -> list:
    """The timer's cycles (B, N, TIMER_SLOTS) of one call that took
    `event_ms` (CUDA events) over T steps, as one row per stage kind of the
    form (`STAGES`, unfused or fused): {"stage", "mean_us", "max_us",
    "share"}, us per step, each (row, rank)'s cycles scaled by the call's
    time over its own loop cycles (so clock boost drops out), the mean and
    the max over ranks averaged over rows, the share of the step; then
    {"stage": "rest", ...}, the step less the stages' means."""
    cyc = torch.as_tensor(buffer).double().cpu()
    slots = list(STAGES[bool(fused)].values())
    if (cyc[..., slots].sum(-1) > cyc[..., TIMER_SLOTS - 1]).any():
        raise ValueError("the timer's counts exceed its loop's: its 32-bit "
                         "counters wrapped (a timed call's time loop must "
                         "stay below 2^32 cycles, about 2 s)")
    step_us = 1e3 * event_ms / T
    scale = step_us / cyc[..., TIMER_SLOTS - 1]          # (B, N)
    rows, total = [], 0.0
    for name, slot in STAGES[bool(fused)].items():
        v = cyc[..., slot] * scale
        mean = float(v.mean(1).mean(0))
        rows.append({"stage": name, "mean_us": mean,
                     "max_us": float(v.max(1).values.mean(0)),
                     "share": mean / step_us})
        total += mean
    rest = step_us - total
    rows.append({"stage": "rest", "mean_us": rest, "max_us": None,
                 "share": rest / step_us})
    return rows
