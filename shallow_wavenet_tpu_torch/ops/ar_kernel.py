"""Persistent AR generation: the wrappers around `csrc/ar_generate.cu` and
`csrc/ar_cluster.cu`, their plain PyTorch version, and the one place that
decides which of them runs (`Layout`, `choose_layout`).

Same contract as `generate_pallas` in shallow_wavenet_tpu/ops/ar_kernel.py:
c_up (B, T, C) fp32 and one uniform per (row, step) in, (B, T) fp32
waveform out; Laplace or softmax head; "sample" or "greedy"; an optional
teacher stream that forces the feedback input on every step, or on steps
t < warmup only (the warm-start of segmented generation). How a call runs
is its `Layout`: the precision (bf16 weights and rings, fp32 accumulation
and sampling), the fused window (the residual recurrence expanded into the
gate inputs within blocks of W layers, `fused_weights`), the kernel
(`ar_cluster.cu`, one thread-block cluster of N SMs per batch row, every
product split along its input dimension over the N ranks,
`cluster_partition`, with its weights in shared memory or streamed from
L2, or its wide form for models whose rings and weights no other form
holds; else `ar_generate.cu`, one SM per row, with the rings of some
layers streamed from global memory, `stream_split`). `choose_layout`
picks it for a model, dtype, fused window and card, from the kernels' own
byte counts and occupancy query, before any launch; `KernelWeights` carry
the layout they were packed for. Softmax class ids are dequantized here,
outside the kernel, with the same op on both versions. `lengths` gives
each row its own number of steps (a padded decode batch): every version
computes each row's samples within its length as the padded call does, to
the bit, and returns 0 past it; the cluster kernel stops each row there
and launches the longest rows first (`cluster_order`), so a batch that
runs in waves ends sooner.

On a CUDA tensor `generate` launches the kernel (one launch for the whole
batch, or for each CLUSTER_MAX_ROWS rows of it on the cluster kernel; the
time loop runs inside it) or raises; on a CPU tensor it runs the
plain version, `generate_plain`, which repeats the kernel's arithmetic,
including its bf16 rounding points, with the same packed-ring recurrence
(layer l owns ring rows [off_l, off_l + d_l), slot off_l + (t & (d_l - 1))).
Where a ring is stored does not change the numbers, so the plain version
keeps every ring in one tensor. `launches` counts kernel launches by
layout (`Layout.name`), `row_steps` the steps the rows ran against the
padded ones, `ring_bytes` where the launches' rings live.

How the weights reach the kernel: `kernel_weights` casts them (bf16) and,
for the fused window, forms its weight products as fp32 matmuls, then
casts them (as the JAX wrapper computes them outside `pallas_call`). A
call given plain params does this once per call (at deep_baseline, 16 MB
of fp32 read once on the card, against thousands of sample steps); a
caller that makes many calls passes the `KernelWeights` it made once. For
a cluster of N they also hold each rank's weight slices packed as the
cluster kernel reads them (`pack_cluster`, or `pack_cluster_fused` with the
fused window).

Not carried over from the TPU kernel: the chunk grid, lane padding and the
VMEM estimate/probe are Mosaic artifacts (zero pads add exact zeros, so
dropping them changes no sum), and `chunk` only picks the streamed layers.
In their place `check_supported` raises on a config the recurrence cannot
take, `smem_bytes` asks the kernel's own layout function what one block
needs, and the kernel's C entry refuses, before it runs, a config whose
layers, classes or shared memory it cannot hold (ValueError here).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import operator

import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.config import ModelConfig
from shallow_wavenet_tpu_torch.models import heads
from shallow_wavenet_tpu_torch.ops import _build
from shallow_wavenet_tpu_torch.ops.mulaw import mulaw_dequantize
from shallow_wavenet_tpu_torch.utils.observability import span

# kernel launches by layout (`Layout.name`) since the last reset; callers
# clear it to count a run
launches: collections.Counter = collections.Counter()
# rows' steps over `generate` calls since the last reset: "run", the steps
# the rows ran (their lengths), and "padded", B x T; 1 - run / padded is
# the share of a padded batch's steps that per-row lengths left out
row_steps: collections.Counter = collections.Counter()
# bytes of ring rows over the cluster kernel's launches since the last
# reset, by where they live: "shared" (the cluster's shared memory) and
# "global" (the wide form's global ring); every row of a launch counts its
# rings once
ring_bytes: collections.Counter = collections.Counter()
# the cluster kernel's clusters per launch (kMaxRows in csrc/ar_cluster.cu):
# a larger batch takes several launches of one call
CLUSTER_MAX_ROWS = 512

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def warmup_length(cfg: ModelConfig, chunk: int = 64) -> int:
    """Teacher-forced warm-start length for segmented generation:
    sum(dilations) + 1 (every layer's correctness horizon) rounded up to a
    whole chunk — the same M as the JAX package."""
    need = int(sum(cfg.dilations)) + 1
    return -(-need // chunk) * chunk


def stream_split(dilations, chunk: int, stream: bool):
    """(resident_layer_ids, streamed_layer_ids) — a copy of the JAX
    package's split: a layer is streamable when its dilation is a >1
    multiple of the chunk (on the TPU, a chunk's ring rows are then one
    contiguous window; here the split only says which rings live in
    global memory)."""
    if not stream:
        return tuple(range(len(dilations))), ()
    res = tuple(l for l, d in enumerate(dilations)
                if d <= chunk or d % chunk != 0)
    strm = tuple(l for l in range(len(dilations)) if l not in res)
    return res, strm


def _streamed_mask(cfg: ModelConfig, layout: Layout):
    strm = stream_split(cfg.dilations, layout.chunk, layout.stream)[1]
    L = len(cfg.dilations)
    return (ctypes.c_int * L)(*(int(l in strm) for l in range(L)))


@dataclasses.dataclass(frozen=True)
class Layout:
    """Which AR kernel runs a call, in what precision, and where its weights
    and rings sit; `Layout()` is the one-SM-per-row kernel in fp32,
    unfused, its rings in shared memory. `choose_layout` picks one for a
    model and card, and `KernelWeights` carry the one they were packed for.

    dtype: "float32", or "bfloat16" for bf16 weights and rings.
    fused: W > 0 runs the fused window over blocks of W layers: equal to
    fused=0 in exact arithmetic, not to the bit (its sums run in another
    order); 0 is the unfused form.
    cluster: N > 0 launches `ar_cluster.cu` (clusters of N blocks, one per
    row), equal to cluster=0 in exact arithmetic, not to the bit; on the
    CPU, the plain version with split=N. 0 launches `ar_generate.cu`.
    wide: the cluster kernel's wide form (fp32, unfused; gate width up to
    2048; the rings of the large dilations in a zeroed global ring made
    for each call, `swt.ar.rings`; the weights streamed from global memory
    in tiles, so resident=False): the same samples as the streamed form,
    to the bit, where both take the model. On the CPU nothing changes.
    resident: the cluster kernel keeps its weights in shared memory; False
    streams them from global memory (L2) a stage at a time. The samples
    do not change.
    stream, chunk: `ar_generate.cu` keeps the rings of the layers whose
    dilation is a >1 multiple of `chunk` (a multiple of 32) in global
    memory (`stream_split`); the samples do not change. chunk also sets
    segmented generation's warm-up length (`warmup_length`).
    Raises ValueError on a combination no kernel runs."""
    dtype: str = "float32"
    fused: int = 0
    cluster: int = 0
    wide: bool = False
    resident: bool = True
    stream: bool = False
    chunk: int = 64

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                             f"{self.dtype!r}")
        if self.fused < 0:
            raise ValueError("fused must be >= 0 (0 disables the fused "
                             "window)")
        if self.cluster < 0:
            raise ValueError("cluster must be >= 0 (0 runs ar_generate)")
        if self.chunk < 32 or self.chunk % 32 != 0:
            raise ValueError("chunk must be a multiple of 32")
        if self.stream and self.cluster:
            raise ValueError("stream is ar_generate's (cluster=0): the "
                             "cluster kernel's rings are its own")
        if not self.resident and not self.cluster:
            raise ValueError("resident=False streams the cluster kernel's "
                             "weights: it needs cluster=N")
        if self.wide and (not self.cluster or self.dtype != "float32"
                          or self.fused or self.resident):
            raise ValueError("the wide form needs cluster=N, float32, no "
                             "fused window and resident=False")

    @property
    def packing(self) -> tuple:
        """What `kernel_weights` packs for, (dtype, fused, cluster): two
        layouts alike in these run on the same weights."""
        return self.dtype, self.fused, self.cluster

    @property
    def name(self) -> str:
        """The kernel variant, as `launches` counts it: `ar_generate[...]`,
        or with cluster = N `ar_cluster[...,N<N>]`, tagged `l2` where the
        cluster kernel streams its weights from L2 a stage at a time
        (`ar_cluster[fused4,N8,l2]`: the fused window W = 4 on clusters of
        8) and `wide` for its wide form (`ar_cluster[N16,wide]`)."""
        bf16 = self.dtype == "bfloat16"
        if self.cluster:
            tags = [t for t, on in (("bf16", bf16),
                                    (f"fused{self.fused}", self.fused > 0),
                                    (f"N{self.cluster}", True),
                                    ("l2", not self.resident
                                     and not self.wide),
                                    ("wide", self.wide)) if on]
            return f"ar_cluster[{','.join(tags)}]"
        tags = [t for t, on in (("bf16", bf16), ("stream", self.stream),
                                (f"fused{self.fused}", self.fused > 0))
                if on]
        return "ar_generate" + (f"[{','.join(tags)}]" if tags else "")


class NoLayoutError(ValueError):
    """No AR kernel layout of the asked dtype and window fits the device."""


# cluster sizes the cluster kernel takes, largest first
CLUSTER_SIZES = (16, 8, 4, 2)


def cluster_partition(cfg: ModelConfig, n: int) -> dict:
    """Which rank of a cluster of n owns which indices: {"h": rows of the
    residual stream, its ring columns and its rows of the tap weights;
    "cond": rows of the conditioning weights; "z": gated activations, and
    their rows of the skip|res weights; "gate": gate columns, j and
    j + G/2 for each j of its z; "skip": skip outputs, its rows of the
    head's first layer and its a1 outputs}, each a list of n ranges (gate:
    lists). Raises ValueError when n does not divide a width."""
    R, G, S, C = (cfg.residual_channels, cfg.gate_channels,
                  cfg.skip_channels, cfg.cond_channels)
    half = G // 2
    widths = (("residual_channels", R), ("gate_channels / 2", half),
              ("cond_channels", C), ("skip_channels", S))
    bad = [f"{name}={w}" for name, w in widths if w % n]
    if n < 1 or bad:
        raise ValueError(f"a cluster of {n} does not divide "
                         + ", ".join(bad or ["n < 1"]))

    def blocks(w):
        return [range(k * w // n, (k + 1) * w // n) for k in range(n)]

    z = blocks(half)
    return {"h": blocks(R), "cond": blocks(C), "z": z, "skip": blocks(S),
            "gate": [list(b) + [half + j for j in b] for b in z]}


def cluster_sizes(cfg: ModelConfig):
    """The cluster sizes of CLUSTER_SIZES whose split divides every width
    (and a gate width that is a multiple of 16), largest first."""
    if cfg.gate_channels % 16:
        return ()
    out = []
    for n in CLUSTER_SIZES:
        try:
            cluster_partition(cfg, n)
        except ValueError:
            continue
        out.append(n)
    return tuple(out)


def _head_width(cfg: ModelConfig) -> int:
    return cfg.quantize_channels if cfg.head == "softmax" else 2


def cluster_stage_stride(cfg: ModelConfig, n: int) -> int:
    """Elements of one stage of a rank's packed weights (`pack_cluster`),
    as `ar_cluster.cu`'s stage_stride: the larger of a layer's
    2 (R/n) G + (C/n) G + (G/2n)(S + R) and the head's (S/n)(S + O),
    rounded up to 8."""
    R, G, S, C = (cfg.residual_channels, cfg.gate_channels,
                  cfg.skip_channels, cfg.cond_channels)
    layer = 2 * (R // n) * G + (C // n) * G + (G // 2 // n) * (S + R)
    head = (S // n) * (S + _head_width(cfg))
    return -(-max(layer, head) // 8) * 8


def pack_cluster(w: dict, cfg: ModelConfig, n: int) -> dict:
    """Each rank's weight slices, packed as the cluster kernel reads them,
    from the kernel's fp32 weights (`kernel_weights`' dict):

      cluster_stages: (n, L + 1, stride): rank k's layer l is
          [W0|W1 rows of its h, (R/n, G, 2) with the taps interleaved |
          cond_w rows of its slice of c, (C/n, G) | skip_w|res_w rows of
          its z, (G/2n, S + R)], its head [head1_w rows of its skip,
          (S/n, S) | head2_w rows, (S/n, O)], each zero-padded to
          `cluster_stage_stride`.
    """
    part = cluster_partition(cfg, n)
    L = len(cfg.dilations)
    stride = cluster_stage_stride(cfg, n)
    rs_w = torch.cat([w["skip_w"], w["res_w"]], dim=-1)
    stages = torch.zeros((n, L + 1, stride), device=w["conv_w"].device)
    for k in range(n):
        hr, zr, sr, cr = (list(part[key][k])
                          for key in ("h", "z", "skip", "cond"))
        layer = torch.cat([
            w["conv_w"][:, :, hr].permute(0, 2, 3, 1).reshape(L, -1),
            w["cond_w"][:, cr].reshape(L, -1),
            rs_w[:, zr].reshape(L, -1)], dim=-1)
        head = torch.cat([w["head1_w"][sr].reshape(-1),
                          w["head2_w"][sr].reshape(-1)])
        stages[k, :L, :layer.shape[1]] = layer
        stages[k, L, :head.numel()] = head
    return {"cluster_stages": stages}


def cluster_fused_stages(cfg: ModelConfig, n: int, fused: int):
    """The fused window's stages of one rank, as `ar_cluster.cu`'s
    fused_stages: [(offset, length)] in the order a step reads them (per
    block of `fused_blocks`, each layer's tap stage of
    (2 R/n + C/n) G elements, then each layer's fm rows, (G/2n) (S + R +
    rem G), rem the later layers of its block; then the head's (S/n)
    (S + O)), each length rounded up to 8 and packed after the last."""
    R, G, S, C = (cfg.residual_channels, cfg.gate_channels,
                  cfg.skip_channels, cfg.cond_channels)
    lens = []
    for blk in fused_blocks(len(cfg.dilations), fused):
        lens += [(2 * (R // n) + C // n) * G] * len(blk)
        lens += [(G // 2 // n) * (S + R + (len(blk) - 1 - k) * G)
                 for k in range(len(blk))]
    lens.append((S // n) * (S + _head_width(cfg)))
    out, at = [], 0
    for length in lens:
        length = -(-length // 8) * 8
        out.append((at, length))
        at += length
    return out


def pack_cluster_fused(w: dict, cfg: ModelConfig, n: int, fused: int
                       ) -> dict:
    """Each rank's weight slices for the fused window, packed as the cluster
    kernel reads them, from the kernel's fp32 fused weights
    (`kernel_weights`' dict, `fused_weights`' fm):

      cluster_stages: (n, total): rank k's stages at the offsets of
          `cluster_fused_stages`: a tap stage is [W0|W1 rows of its h,
          (R/n, G, 2) with the taps interleaved | cond_w rows of its slice
          of c, (C/n, G)], as `pack_cluster`'s; an fm stage is layer l's
          fm rows of its z, (G/2n, S + R + rem G); the head as
          `pack_cluster`'s; zero-padded to each stage's length.
    """
    part = cluster_partition(cfg, n)
    L = len(cfg.dilations)
    layout = cluster_fused_stages(cfg, n, fused)
    fm = fm_layers(w["fm"], cfg, fused)
    order = [(kind, l) for blk in fused_blocks(L, fused)
             for kind in ("tap", "fm") for l in blk] + [("head", L)]
    total = layout[-1][0] + layout[-1][1]
    stages = torch.zeros((n, total), device=w["conv_w"].device)
    for k in range(n):
        hr, zr, sr, cr = (list(part[key][k])
                          for key in ("h", "z", "skip", "cond"))
        for (kind, l), (at, _) in zip(order, layout):
            if kind == "tap":
                x = torch.cat([
                    w["conv_w"][l][:, hr].permute(1, 2, 0).reshape(-1),
                    w["cond_w"][l, cr].reshape(-1)])
            elif kind == "fm":
                x = fm[l][zr].reshape(-1)
            else:
                x = torch.cat([w["head1_w"][sr].reshape(-1),
                               w["head2_w"][sr].reshape(-1)])
            stages[k, at:at + x.numel()] = x
    return {"cluster_stages": stages}


def fused_blocks(n_layers: int, fused: int):
    """Contiguous layer windows of the fused form (a copy of the JAX
    package's `_fused_blocks`)."""
    return tuple(tuple(range(b, min(b + fused, n_layers)))
                 for b in range(0, n_layers, fused))


def fused_weights(pp: dict, cfg: ModelConfig, fused: int) -> dict:
    """The fused window's weights, fp32, from plain params (the JAX
    wrapper's construction without its lane padding):

      fm: every layer's [skip_w | res_w | res_w @ W1_m for each later layer
          m of its block], (G/2, S + R + rem_l * G), flattened and packed in
          layer order (as the kernel's `pack_fm` reads them; `fm_layers`
          splits them again);
      conv_b: (L, G), each layer's bias plus res_b_j @ W1_m of every
          earlier layer j of its block, added in layer order.

    The block input's weights are the layers' own tap-1 weights side by
    side, which the kernel reads from conv_w.
    """
    f32 = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in pp.items()}
    w1 = f32["conv_w"][:, 1]                                 # (L, R, G)
    conv_b = f32["conv_b"].clone()
    fm = []
    for blk in fused_blocks(len(cfg.dilations), fused):
        for k, l in enumerate(blk):
            parts = [f32["skip_w"][l], f32["res_w"][l]]
            for m in blk[k + 1:]:
                parts.append(f32["res_w"][l] @ w1[m])
                conv_b[m] = conv_b[m] + f32["res_b"][l] @ w1[m]
            fm.append(torch.cat(parts, dim=-1).reshape(-1))
    return {"fm": torch.cat(fm), "conv_b": conv_b}


def fm_layers(fm, cfg: ModelConfig, fused: int):
    """The packed fused projections (`fused_weights`) as one
    (G/2, S + R + rem_l * G) matrix per layer, in layer order."""
    half = cfg.gate_channels // 2
    cols = [cfg.skip_channels + cfg.residual_channels
            + (len(blk) - 1 - k) * cfg.gate_channels
            for blk in fused_blocks(len(cfg.dilations), fused)
            for k in range(len(blk))]
    return [m.reshape(half, c)
            for m, c in zip(fm.split([half * c for c in cols]), cols)]


@dataclasses.dataclass(frozen=True)
class KernelWeights:
    """Plain params as the kernel reads them, packed for one layout, on one
    device (`kernel_weights`). A caller that makes many calls with the same
    weights (the streaming session, segmented generation) makes them once
    and passes them to `generate` in place of the plain params; the call
    then runs their layout."""
    tensors: dict
    layout: Layout


def kernel_weights(pp, cfg: ModelConfig, layout: Layout = Layout(),
                   device=None) -> KernelWeights:
    """The kernel's weights for `layout` from plain params, on `device`
    (None: CUDA): the input projection (or the softmax embedding) as
    in_w/in_b, with the fused window W the window's `fm` and folded conv_b
    in place of res_w, skip_w and conv_b, with cluster = N also every
    rank's packed slices (`pack_cluster`; `pack_cluster_fused` with the
    fused window), every tensor cast to the layout's dtype. Given
    KernelWeights, returns them."""
    if isinstance(pp, KernelWeights):
        return pp
    dev = resolve_device(device)
    fused, cluster = layout.fused, layout.cluster
    with span("swt.ar.pack"):
        w = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
             for k, v in pp.items()}
        if cfg.head == "softmax":
            w["in_w"] = w.pop("input_embed")
            w["in_b"] = torch.zeros(cfg.residual_channels, device=dev)
        else:
            w["in_w"], w["in_b"] = w.pop("input_w"), w.pop("input_b")
        if fused:
            w.update(fused_weights(w, cfg, fused))
            del w["res_w"], w["skip_w"]
        if cluster and fused:
            w.update(pack_cluster_fused(w, cfg, cluster, fused))
        elif cluster:
            w.update(pack_cluster(w, cfg, cluster))
        return KernelWeights({k: v.to(DTYPES[layout.dtype]).contiguous()
                              for k, v in w.items()}, layout)


def layout_of(pp, layout: Layout | None = None) -> Layout:
    """The layout a call on `pp` runs: `layout`, else the weights' own
    (given KernelWeights), else `Layout()`."""
    if layout is not None:
        return layout
    return pp.layout if isinstance(pp, KernelWeights) else Layout()


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError on a config the packed-ring recurrence (kernel and
    plain version) cannot take. The kernel's own limits are checked by its
    C entry; batch rows are independent blocks, so every batch size fits
    once the config does."""
    bad = []
    if cfg.kernel_size != 2:
        bad.append(f"kernel_size={cfg.kernel_size} (needs 2)")
    if cfg.gate_channels % 2:
        bad.append("gate_channels must be even")
    if bad:
        raise ValueError("config not supported by the AR kernel: "
                         + "; ".join(bad))


def uniform_noise(shape, generator: torch.Generator):
    """Uniforms in [1e-7, 1 - 1e-7], drawn on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (1.0 - 2e-7) + 1e-7


def row_lengths(lengths, B: int, T: int, n_forced: int = 0) -> list:
    """`generate`'s lengths as B Python ints, each in [max(1, n_forced),
    T] (a row stops no earlier than its teacher-forced steps); raises
    ValueError otherwise."""
    try:
        out = [operator.index(n) for n in lengths]
    except TypeError as e:
        raise ValueError(f"lengths must be integers: {e}") from None
    low = max(1, n_forced)
    if len(out) != B or any(not low <= n <= T for n in out):
        raise ValueError(f"lengths must be {B} integers in [{low}, {T}] "
                         f"(1, or the forced steps, to T), got {out}")
    return out


def cluster_order(lengths) -> list:
    """The rows longest first, equal lengths in row order (a stable
    argsort): cluster k of the cluster kernel runs row order[k]. The
    clusters of a launch start in this order as SMs free up, so a batch
    in waves runs its shortest rows last (on the offline mix, 8 rows of
    75-150 frames on 7 clusters, no order of the rows ends sooner)."""
    return sorted(range(len(lengths)), key=lambda r: -lengths[r])


def _zero_tails(out, lengths) -> None:
    for r, n in enumerate(lengths):
        out[r, n:] = 0.0


def _prepare(pp, cfg, c_up, noise, mode, teacher, warmup, generator,
             unroll, dev, layout):
    if mode not in ("sample", "greedy"):
        raise ValueError(f"mode must be 'sample' or 'greedy', got {mode!r}")
    if warmup < 0:
        raise ValueError("warmup must be >= 0")
    if warmup > 0 and teacher is None:
        raise ValueError("warmup requires a teacher prefix stream")
    if unroll < 1:
        raise ValueError("unroll must be >= 1")
    check_supported(cfg)
    c_up = torch.as_tensor(c_up, dtype=torch.float32).to(dev).contiguous()
    B, T, C = c_up.shape
    if C != cfg.cond_channels:
        raise ValueError(f"c_up has {C} channels, config {cfg.cond_channels}")

    def stream_of(x, fill, what):
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        if x.ndim != 2 or x.shape[0] != B or x.shape[1] > T:
            raise ValueError(f"{what} must be (B, <=T) = ({B}, <={T}), got "
                             f"{tuple(x.shape)}")
        if x.shape[1] < T:
            x = torch.nn.functional.pad(x, (0, T - x.shape[1]), value=fill)
        return x.contiguous()

    if mode == "greedy":
        noise = torch.full((B, T), 0.5, device=dev)
    elif noise is None:
        if generator is None:
            raise ValueError("sample mode needs generator or noise")
        noise = uniform_noise((B, T), generator).to(dev)
    else:
        noise = stream_of(noise, 0.5, "noise")
    n_forced = 0
    if teacher is not None:
        teacher = stream_of(teacher, 0.0, "teacher")
        n_forced = T if warmup == 0 else min(warmup, T)

    w = kernel_weights(pp, cfg, layout, dev)
    if w.layout.packing != layout.packing or any(
            v.device != c_up.device for v in w.tensors.values()):
        raise ValueError(
            f"kernel weights are packed for {w.layout} on "
            f"{next(iter(w.tensors.values())).device}; the call asks for "
            f"{layout} on {c_up.device}")
    return c_up, noise, teacher, n_forced, w.tensors


def _finish(cfg: ModelConfig, raw):
    if cfg.head == "softmax":
        return mulaw_dequantize(raw.to(torch.int32), cfg.quantize_channels)
    return raw


def generate(pp, cfg: ModelConfig, c_up, noise=None,
             mode: str = "sample", teacher=None, warmup: int = 0,
             generator=None, unroll: int = 1, device=None, *,
             layout: Layout | None = None, dtype: str | None = None,
             lengths=None):
    """AR generation; returns (B, T) fp32 on `device`.

    pp: plain params (models.wavenet.extract_plain_params), or the
    `KernelWeights` made from them on this device; c_up (B, T, C).
    noise: (B, <=T) uniforms in (0, 1), padded with 0.5; drawn from
    `generator` in [1e-7, 1 - 1e-7] when omitted (sample mode).
    teacher: optional (B, <=T) forced feedback stream (samples, or class ids
    as floats for the softmax head), padded with zeros. warmup > 0 forces
    only steps t < warmup; warmup >= sum(dilations) + 1 rebuilds every ring.
    unroll: kept for the `generate_pallas` contract (>= 1); the kernel's
    loop has no unroll knob, and unrolling never changes the samples.
    device: None means "cuda" (raises without CUDA); "cpu" runs the plain
    version.
    layout: the `Layout` to run; None runs the weights' own (given
    KernelWeights) or `Layout()`. With KernelWeights it must be packed as
    theirs (dtype, fused window, cluster size; ValueError otherwise), so a
    timing caller may run one packing in both weight placements. A launch
    the kernel refuses (cluster size, fused window, shared memory,
    occupancy) raises.
    dtype: None, or the layout's dtype (ValueError otherwise).
    lengths: None, or B host integers, the steps of each row, each in
    [1, T] and no fewer than the teacher-forced steps (ValueError
    otherwise): each row's samples within its length are the padded
    call's, to the bit, and 0 past it. The cluster kernel stops each row
    at its length and starts the longest rows first (`cluster_order`);
    `ar_generate.cu` runs the padded rows; the plain version stops at the
    longest.
    """
    with span("swt.ar.generate"):
        dev = resolve_device(device)
        layout = layout_of(pp, layout)
        # the benchmark's tracer reads the dtype from the call's keywords,
        # so the decode mirrors the layout's here
        if dtype is not None and dtype != layout.dtype:
            raise ValueError(f"dtype={dtype!r} differs from the layout's "
                             f"{layout.dtype!r}")
        args = _prepare(pp, cfg, c_up, noise, mode, teacher, warmup,
                        generator, unroll, dev, layout)
        B, T = args[0].shape[:2]
        if lengths is not None:
            lengths = row_lengths(lengths, B, T, args[3])
        with span("swt.ar.launch"):
            if args[0].is_cuda and layout.cluster:
                raw = _launch_cluster(cfg, mode == "greedy", *args, layout,
                                      lengths=lengths)
            elif args[0].is_cuda:
                raw = _launch(cfg, mode == "greedy", *args, layout)
                if lengths is not None:
                    _zero_tails(raw, lengths)
            else:
                raw = _plain(cfg, mode == "greedy", *args,
                             fused=layout.fused, split=layout.cluster,
                             lengths=lengths)
        row_steps["run"] += sum(lengths) if lengths is not None else B * T
        row_steps["padded"] += B * T
        return _finish(cfg, raw)


def generate_plain(pp, cfg: ModelConfig, c_up, noise=None,
                   mode: str = "sample", teacher=None, warmup: int = 0,
                   generator=None, unroll: int = 1, device=None, *,
                   fused: int = 0, dtype: str = "float32",
                   chain: bool = False, split: int = 0, graph: bool = False,
                   lengths=None):
    """The plain PyTorch version of `generate`, on any device: one Python
    step per sample, the kernel's arithmetic in torch ops, for `dtype` and
    the fused window `fused` (the layout's fields that change its numbers;
    where the rings and weights are stored changes nothing here). pp: plain
    params, or KernelWeights packed for them without a cluster.

    graph: on a CUDA device, capture one step in a CUDA graph and replay it
    once per sample, instead of dispatching its torch ops from Python each
    step (the host's dispatch is most of an eager step's time). The step
    reads its index, ring slots, conditioning, uniform and teacher sample
    through device tensors, with the same ops on the same values, so the
    samples are those of the eager loop (held to the bit on the card by
    chip_smoke). The CPU path is the eager loop.

    chain: sum every product of a dot as one fp32 chain in k order and form
    the gate's sigmoid as 1 / (1 + exp(-x)), as the kernel does, instead of
    matmuls that sum in their own order. With dtype="bfloat16" every
    product is of two bf16 values, hence exact in fp32, so with the Laplace
    head this is the kernel's arithmetic operation for operation: on a card
    it meets the kernel to the bit wherever torch's tanh, exp and log1p
    give the kernel's values. With `fused`, every gate input is summed in
    the kernel's order too: its base (tap 0, folded bias, conditioning),
    then the block input, then each earlier layer's P term in layer order.
    Slow on the CPU: one torch op per k (on CUDA, one cumsum per dot).

    split: N > 0 sums in the cluster kernel's order (`cluster=N`), with
    `chain`: every dot as N chains, one over each rank's contiguous slice
    of k (`cluster_partition`), then the N partials in rank order; a gate
    input is ((sum over ranks of (tap0 + tap1) + b) + sum over ranks of
    the conditioning); with `fused` = W, ((sum over ranks of tap0 + b) +
    sum over ranks of the conditioning) + sum over ranks of the block
    input's tap 1, then + the sum over ranks of each earlier layer's P
    term of the block, in layer order (`ar_cluster.cu`'s fused order). So
    split=1 is the order of chain=True alone, fused or not. Without
    `chain`, matmuls sum in their own order and split changes nothing.

    lengths: as `generate`'s; the loop stops at the longest row.
    """
    dev = resolve_device(device)
    args = _prepare(pp, cfg, c_up, noise, mode, teacher, warmup, generator,
                    unroll, dev, Layout(dtype, fused))
    if graph and dev.type != "cuda":
        raise ValueError("graph replay needs a CUDA device")
    if lengths is not None:
        lengths = row_lengths(lengths, *args[0].shape[:2], args[3])
    return _finish(cfg, _plain(cfg, mode == "greedy", *args, fused=fused,
                               chain=chain, split=split, graph=graph,
                               lengths=lengths))


def _chain_sum(p, dim):
    """p summed over `dim` as one fp32 chain in index order, from 0."""
    if p.is_cuda:
        # ATen's CUDA cumsum over a dim that is not the innermost gives
        # each output one thread that adds in index order in fp32, from 0
        return p.cumsum(dim).select(dim, -1)
    # the CPU's cumsum accumulates in double: add step by step
    acc = torch.zeros_like(p.select(dim, 0))
    for k in range(p.shape[dim]):
        acc += p.select(dim, k)
    return acc


def _dots(chain: bool, *pairs):
    """[x @ m for (x, m) in pairs], all of one k length; in `chain` mode
    each output is one fp32 chain in k order, as the kernel's dot_col."""
    if not chain:
        return [x @ m for x, m in pairs]
    p = torch.cat([x[:, :, None] * m[None] for x, m in pairs], dim=-1)
    return _chain_sum(p, 1).split([m.shape[1] for _, m in pairs], dim=-1)


def split_sum(pairs, split: int = 0, chain: bool = False, owners=None):
    """The sum of the pairs' products, x0 @ m0 + x1 @ m1 + ..., all of one
    k length. With `split` = N and `chain`, in the cluster kernel's order:
    per rank, each pair's chain over the rank's contiguous slice of k
    (`cluster_partition`), added in pair order, then the ranks' partials in
    rank order. owners: (out,) rank ids, the cluster probe's
    local_exchange: each output keeps its owner's partial alone, chained
    or (without `chain`) a matmul over the owner's slice."""
    if owners is None and not (split and chain):
        out = _dots(chain, *pairs)
        acc = out[0]
        for o in out[1:]:
            acc = acc + o
        return acc
    part = None
    for x, m in pairs:
        B, K = x.shape
        if chain:
            p = (x[:, :, None] * m[None]).reshape(B, split, K // split, -1)
            c = _chain_sum(p, 2)                       # (B, split, out)
        else:
            c = torch.einsum("bsk,sko->bso", x.reshape(B, split, -1),
                             m.reshape(split, K // split, -1))
        part = c if part is None else part + c
    if owners is None:
        return _chain_sum(part, 1)
    idx = owners.to(part.device).view(1, 1, -1).expand(part.shape[0], 1, -1)
    return part.gather(1, idx).squeeze(1)


@torch.no_grad()
def _plain(cfg, greedy, c_up, noise, teacher, n_forced, w, fused=0,
           chain=False, split=0, graph=False, lengths=None):
    B, T, C = c_up.shape
    steps = T if lengths is None else max(lengths)
    dil = cfg.dilations
    L, R, G, S = (len(dil), cfg.residual_channels, cfg.gate_channels,
                  cfg.skip_channels)
    half = G // 2
    offs = [sum(dil[:l]) for l in range(L)]
    dev = c_up.device
    softmax = cfg.head == "softmax"
    # bf16 values held in fp32: products of two of them are exact, so the
    # fp32 matmuls below are the kernel's bf16 dots with fp32 accumulation;
    # rnd is the kernel's rounding to the storage type
    bf16 = w["conv_w"].dtype == torch.bfloat16
    w = {k: v.float() for k, v in w.items()}

    def rnd(x):
        return x.bfloat16().float() if bf16 else x

    def dots(*pairs):
        return _dots(chain, *pairs)

    def dot_sum(*pairs):
        return split_sum(pairs, split, chain)

    def sigmoid(x):
        return 1.0 / (1.0 + torch.exp(-x)) if chain else torch.sigmoid(x)

    rings = torch.zeros(sum(dil), B, R, device=dev)
    cond_wcat = w["cond_w"].permute(1, 0, 2).reshape(C, L * G)
    if fused:
        blocks = fused_blocks(L, fused)
        fm = fm_layers(w["fm"], cfg, fused)
        # the block input's weights: its layers' tap-1 weights side by side
        w1cat = [torch.cat([w["conv_w"][l, 1] for l in blk], dim=-1)
                 for blk in blocks]
    else:
        rs_w = torch.cat([w["skip_w"], w["res_w"]], dim=-1)  # (L, G/2, S+R)
    rs_b = torch.cat([w["skip_b"], w["res_b"]], dim=-1)
    fb = torch.full((B,), float(cfg.quantize_channels // 2) if softmax
                    else 0.0, device=dev)
    out = (torch.empty if lengths is None else torch.zeros)(B, T, device=dev)

    def step(x_in, c_t, u_t, read, write):
        """One sample: x_in the feedback input, c_t (B, C) and u_t (B,)
        the step's conditioning and uniforms; read(l) gives layer l's ring
        row for this step and write(l, h) stores h there."""
        if softmax:
            h = w["in_w"][x_in.long()]
        else:
            h = rnd(rnd(rnd(x_in)[:, None] * w["in_w"][0][None, :])
                    + w["in_b"][None, :])
        cc = dot_sum((rnd(c_t), cond_wcat))
        skip = torch.zeros(B, S, device=dev)
        if fused:
            # every layer's base, then per block: the block input, then
            # each layer's z @ [skip | res | P toward the later layers]
            taps = ([dot_sum((read(l), w["conv_w"][l, 0]))
                     for l in range(L)] if split else
                    dots(*((read(l), w["conv_w"][l, 0])
                           for l in range(L))))
            base = [(taps[l] + w["conv_b"][l]) + cc[:, l * G:(l + 1) * G]
                    for l in range(L)]
            for bi, blk in enumerate(blocks):
                a = dot_sum((h, w1cat[bi]))
                us = [base[l] + a[:, k * G:(k + 1) * G]
                      for k, l in enumerate(blk)]
                for k, l in enumerate(blk):
                    z = rnd(torch.tanh(us[k][:, :half])
                            * sigmoid(us[k][:, half:]))
                    o = dot_sum((z, fm[l]))
                    for q in range(k + 1, len(blk)):
                        p0 = S + R + (q - k - 1) * G
                        us[q] = us[q] + o[:, p0:p0 + G]
                    rs = o[:, :S + R] + rs_b[l]
                    write(l, h)
                    h = rnd(h + rs[:, S:])
                    skip = skip + rs[:, :S]
        else:
            for l in range(L):
                g = dot_sum((read(l), w["conv_w"][l, 0]),
                            (h, w["conv_w"][l, 1]))
                u = (g + w["conv_b"][l]) + cc[:, l * G:(l + 1) * G]
                z = rnd(torch.tanh(u[:, :half]) * sigmoid(u[:, half:]))
                write(l, h)
                rs = dot_sum((z, rs_w[l])) + rs_b[l]
                h = rnd(h + rs[:, S:])
                skip = skip + rs[:, :S]
        o = dot_sum((rnd(torch.relu(skip)), w["head1_w"]))
        o = rnd(torch.relu(o + w["head1_b"]))
        o = dot_sum((o, w["head2_w"])) + w["head2_b"]
        if softmax:
            ids = (torch.argmax(o, dim=-1) if greedy
                   else heads.categorical_from_uniform(o, u_t))
            return ids.float()
        x = o[:, 0] if greedy else heads.laplace_from_uniform(
            o, u_t - 0.5, cfg.log_b_min, cfg.log_b_max)
        return torch.clamp(x, -1.0, 1.0)

    if graph:
        _replay(step, rings, out, fb, c_up, noise, teacher, n_forced, offs,
                dil, steps)
    else:
        for t in range(steps):
            slots = [offs[l] + (t & (dil[l] - 1)) for l in range(L)]
            x = step(teacher[:, t] if t < n_forced else fb, c_up[:, t],
                     noise[:, t], lambda l: rings[slots[l]],
                     lambda l, h: rings.__setitem__(slots[l], h))
            out[:, t] = x
            fb = x
    if lengths is not None:
        _zero_tails(out, lengths)
    return out


def _replay(step, rings, out, fb, c_up, noise, teacher, n_forced, offs,
            dil, steps):
    """`_plain`'s loop as one captured step replayed `steps` times: the
    step index, its ring slots and the feedback live on the card, and the
    step reads c_up, noise and teacher at its index (index_select) and
    writes its ring rows and output column there (index_copy_)."""
    T = out.shape[1]
    dev = out.device
    t_dev = torch.zeros(1, dtype=torch.long, device=dev)
    offs = torch.tensor(offs, device=dev)
    masks = torch.tensor([d - 1 for d in dil], device=dev)
    fb0, fb = fb, fb.clone()

    def one():
        slot = offs + (t_dev & masks)
        at = [slot[l:l + 1] for l in range(len(dil))]
        if teacher is None or n_forced == 0:
            x_in = fb
        else:
            forced = teacher.index_select(1, t_dev)[:, 0]
            x_in = forced if n_forced >= T else torch.where(
                t_dev < n_forced, forced, fb)
        x = step(x_in, c_up.index_select(1, t_dev)[:, 0],
                 noise.index_select(1, t_dev)[:, 0],
                 lambda l: rings.index_select(0, at[l])[0],
                 lambda l, h: rings.index_copy_(0, at[l], h[None]))
        out.index_copy_(1, t_dev, x[:, None])
        fb.copy_(x)
        t_dev.add_(1)

    # a warm-up step on a side stream (the library handles and the graph
    # pool's blocks), then the state it moved is put back
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        one()
    torch.cuda.current_stream(dev).wait_stream(side)
    rings.zero_()
    t_dev.zero_()
    fb.copy_(fb0)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        one()
    for _ in range(steps):
        g.replay()


def _lib() -> ctypes.CDLL:
    lib = _build.load("ar_generate")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ints = ctypes.POINTER(i32)
    lib.ar_generate.argtypes = ([ptr] * 19 + [ints, ints] + [i32] * 14
                                + [f32, f32, ptr])
    lib.ar_generate.restype = i32
    lib.ar_smem_bytes.argtypes = [ints, ints] + [i32] * 8
    lib.ar_smem_bytes.restype = ctypes.c_longlong
    lib.ar_smem_limit.argtypes = [ints]
    lib.ar_smem_limit.restype = i32
    lib.ar_error_string.argtypes = [i32]
    lib.ar_error_string.restype = ctypes.c_char_p
    return lib


def _refusal(lib, err: int) -> ValueError:
    return ValueError("config not supported by the AR kernel: "
                      + lib.ar_error_string(err).decode())


def smem_bytes(cfg: ModelConfig, layout: Layout = Layout()) -> int:
    """Shared memory one block of `ar_generate.cu` needs for this layout
    (cluster=0), from the kernel's own layout function (builds the kernel's
    library)."""
    lib = _lib()
    dil = (ctypes.c_int * len(cfg.dilations))(*cfg.dilations)
    n = lib.ar_smem_bytes(dil, _streamed_mask(cfg, layout),
                          len(cfg.dilations), cfg.residual_channels,
                          cfg.gate_channels, cfg.skip_channels,
                          cfg.cond_channels, _head_width(cfg),
                          int(layout.dtype == "bfloat16"), layout.fused)
    if n < 0:
        raise _refusal(lib, n)
    return n


def smem_limit(device) -> int:
    """The CUDA device's shared memory per block (opt-in maximum), as the
    kernels' own `ar_smem_limit` reads it (232,448 B on an H100)."""
    return torch.cuda.get_device_properties(
        resolve_device(device)).shared_memory_per_block_optin


def _launch(cfg, greedy, c_up, noise, teacher, n_forced, w, layout):
    lib = _lib()
    B, T, C = c_up.shape
    R = cfg.residual_channels
    out = torch.empty((B, T), dtype=torch.float32, device=c_up.device)
    L = len(cfg.dilations)
    dil = (ctypes.c_int * L)(*cfg.dilations)
    streamed = _streamed_mask(cfg, layout)
    strm_rows = sum(d for d, s in zip(cfg.dilations, streamed) if s)
    # zeroed, so that steps t < d read zeros from a streamed ring
    strm_ring = (torch.zeros((B, strm_rows, R), dtype=DTYPES[layout.dtype],
                             device=c_up.device) if strm_rows else None)
    softmax = cfg.head == "softmax"

    def ptr(k):
        return w[k].data_ptr() if k in w else None

    with torch.cuda.device(c_up.device):
        err = lib.ar_generate(
            c_up.data_ptr(), noise.data_ptr(),
            None if teacher is None else teacher.data_ptr(), out.data_ptr(),
            *(ptr(k) for k in (
                "in_w", "in_b", "conv_w", "conv_b", "cond_w", "res_w",
                "res_b", "skip_w", "skip_b", "head1_w", "head1_b",
                "head2_w", "head2_b", "fm")),
            None if strm_ring is None else strm_ring.data_ptr(),
            dil, streamed, B, T, L, R, cfg.gate_channels, cfg.skip_channels,
            C, cfg.quantize_channels, _head_width(cfg), int(softmax),
            int(greedy), n_forced, int(layout.dtype == "bfloat16"),
            layout.fused, cfg.log_b_min, cfg.log_b_max,
            torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise _refusal(lib, err)
    if err != 0:
        raise RuntimeError("ar_generate launch failed: "
                           + lib.ar_error_string(err).decode())
    # a streamed layout that streams no layer runs (and counts) resident
    launches[dataclasses.replace(layout, stream=strm_rows > 0).name] += 1
    return out


def _cluster_lib() -> ctypes.CDLL:
    lib = _build.load("ar_cluster")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ints = ctypes.POINTER(i32)
    lib.ar_cluster_generate.argtypes = ([ptr] * 4 + [ints] * 2 + [ptr] * 8
                                        + [ints] + [i32] * 16
                                        + [f32, f32, ptr, ptr])
    lib.ar_cluster_generate.restype = i32
    lib.ar_cluster_smem_bytes.argtypes = [ints] + [i32] * 10
    lib.ar_cluster_smem_bytes.restype = ctypes.c_longlong
    lib.ar_cluster_max_active.argtypes = [ints] + [i32] * 10 + [ints]
    lib.ar_cluster_max_active.restype = i32
    lib.ar_cluster_stage_stride.argtypes = [i32] * 6
    lib.ar_cluster_stage_stride.restype = i32
    lib.ar_cluster_fused_stages.argtypes = [i32] * 8 + [ints] * 2
    lib.ar_cluster_fused_stages.restype = i32
    lib.ar_cluster_rings.argtypes = [ints] + [i32] * 9 + [ints] * 2
    lib.ar_cluster_rings.restype = i32
    lib.ar_cluster_error_string.argtypes = [i32]
    lib.ar_cluster_error_string.restype = ctypes.c_char_p
    return lib


def _cluster_refusal(lib, err: int) -> ValueError:
    return ValueError("config not supported by the cluster AR kernel: "
                      + lib.ar_cluster_error_string(err).decode())


# the cluster kernel's forms, as its entry points take them (`resident`)
_STREAMED, _RESIDENT, _WIDE = 0, 1, 2


def _cluster_shape(cfg: ModelConfig, layout: Layout):
    L = len(cfg.dilations)
    form = (_WIDE if layout.wide else _RESIDENT if layout.resident
            else _STREAMED)
    return ((ctypes.c_int * L)(*cfg.dilations), L, cfg.residual_channels,
            cfg.gate_channels, cfg.skip_channels, cfg.cond_channels,
            _head_width(cfg), layout.cluster,
            int(layout.dtype == "bfloat16"), form, layout.fused)


def cluster_smem_bytes(cfg: ModelConfig, layout: Layout) -> int:
    """Shared memory one block of the cluster kernel needs in this layout
    (cluster=N), from the kernel's own layout function (builds the kernel's
    library). Raises ValueError on a shape the kernel refuses."""
    lib = _cluster_lib()
    b = lib.ar_cluster_smem_bytes(*_cluster_shape(cfg, layout))
    if b < 0:
        raise _cluster_refusal(lib, b)
    return b


def cluster_rings(cfg: ModelConfig, layout: Layout) -> tuple[int, int]:
    """(ring rows one batch row keeps in the cluster's shared memory, ring
    rows it keeps in the wide form's global ring) in this layout
    (cluster=N), from the kernel's own rule (builds its library for the
    wide form): every row in shared memory but in the wide form, which
    keeps only its small dilations' there (`pack_rings_wide`). Raises
    ValueError on a shape the kernel refuses."""
    if not layout.wide:
        return sum(cfg.dilations), 0
    lib = _cluster_lib()
    rows, grows = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.ar_cluster_rings(*_cluster_shape(cfg, layout)[:-1],
                               ctypes.byref(rows), ctypes.byref(grows))
    if err < 0:
        raise _cluster_refusal(lib, err)
    return rows.value, grows.value


def clusters_at_once(cfg: ModelConfig, layout: Layout, device=None
                     ) -> int | None:
    """The rows the card runs at once in this layout: its clusters that fit
    the CUDA `device` together (cudaOccupancyMaxActiveClusters), so that a
    batch of more rows runs in waves; None off the card or off the cluster
    kernel."""
    dev = resolve_device(device)
    if dev.type != "cuda" or not layout.cluster:
        return None
    lib = _cluster_lib()
    count = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.ar_cluster_max_active(*_cluster_shape(cfg, layout),
                                        ctypes.byref(count))
    if err < 0:
        raise _cluster_refusal(lib, err)
    if err:
        raise RuntimeError("cudaOccupancyMaxActiveClusters failed: "
                           + lib.ar_cluster_error_string(err).decode())
    return count.value


# A cluster size fills the card when its clusters, all resident at once,
# cover at least this share of the SMs (GPCs hold whole clusters only: an
# H100 holds 7 clusters of 16, 112 of its 132 SMs, and 15 of 8). A choice
# made for the H100 from chip_smoke.py's `cluster` phase, which times every
# size that fits at B = 1 and 8: at config 2 the size it picks, 8, is the
# fastest at both (16 is slower even at B = 1, and runs B = 8 in two
# waves); at deep_baseline bf16, 16 is a few percent faster at B = 1 and
# half as fast at B = 8.
FILL_SHARE = 0.9


def _cluster_layout(cfg: ModelConfig, dtype: str, dev, fused: int, sizes,
                    wide: bool = False) -> Layout | None:
    """The cluster layout of `sizes` (largest first) for this dtype and
    fused window on `dev`, never from the batch, or None. Of the sizes
    whose block fits the card's shared memory (weights resident, else
    streamed from L2) with at least one cluster resident (the kernel's own
    byte counts and occupancy query): the largest that fills the card (N x
    clusters at once >= FILL_SHARE x SMs), so that a batch as large as the
    card's clusters leaves no SM idle; else the largest that fits. With
    `wide`, of the wide form, simply the largest that fits: each SM there
    streams 1/N of weights that stay off the chip, so the larger N, the
    fewer bytes each SM pulls a step. On the CPU, the largest (never the
    wide form)."""
    if dev.type != "cuda":
        return Layout(dtype, fused, sizes[0]) if sizes and not wide else None
    limit, fits = smem_limit(dev), []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in sizes:
        try:
            lay = Layout(dtype, fused, n, wide=wide, resident=not wide)
            if cluster_smem_bytes(cfg, lay) > limit:
                if wide:
                    continue
                lay = dataclasses.replace(lay, resident=False)
                if cluster_smem_bytes(cfg, lay) > limit:
                    continue
        except ValueError:   # a shape or fused window the kernel refuses
            continue
        active = clusters_at_once(cfg, lay, dev)
        if active >= 1:
            fits.append(lay)
            if wide or n * active >= FILL_SHARE * sms:
                return lay
    return fits[0] if fits else None


def choose_layout(cfg: ModelConfig, dtype: str = "auto", device=None,
                  fused: int = 0, cluster=True) -> Layout:
    """The layout that runs this model on `device`, of `dtype` ("auto":
    any) and the fused window W = fused: the first that fits of this
    ladder, every fp32 layout before any bf16 one, as in the JAX decode's
    tier order (PALLAS_TIERS), so "auto" lowers the precision only where
    no fp32 layout fits. Within a dtype: the cluster kernel at the size
    the model, window and card take (`_cluster_layout`; its weights in
    shared memory where they fit a block, else from L2); then
    `ar_generate.cu` where its block's shared memory (`smem_bytes`) fits,
    its rings resident, then streamed at chunk 64 and at 32 (a streamed
    layout that streams no layer is the resident one and is skipped; the
    library is built only when one of these is weighed); last of the fp32
    layouts, on a card and unfused, the cluster kernel's wide form, for
    models that no fp32 layout above holds (the speaker-dependent
    vocoder's R 512, G 1024), so that every model one of them fits keeps
    it. The layouts of one kernel and dtype give identical samples.
    On the CPU, where the plain version has no such limits, the first of
    the dtype. cluster: True weighs every cluster size, False none, N
    only N (and then no `ar_generate.cu` layout). Decided before any
    launch, never from the batch. Raises NoLayoutError (a ValueError) when
    none fits."""
    dev = resolve_device(device)
    if dtype not in ("auto", *DTYPES):
        raise ValueError(f"unknown kernel dtype {dtype!r}")
    sizes = (cluster_sizes(cfg) if cluster is True else
             tuple(n for n in cluster_sizes(cfg) if n == cluster))
    # ar_generate's (stream, chunk), but where the caller asked for one N
    rungs = (((False, 64), (True, 64), (True, 32))
             if cluster is True or not cluster else ())
    for dt in DTYPES if dtype == "auto" else (dtype,):
        lay = _cluster_layout(cfg, dt, dev, fused, sizes)
        if lay:
            return lay
        for stream, chunk in rungs:
            lay = Layout(dt, fused, stream=stream, chunk=chunk)
            if stream and not stream_split(cfg.dilations, chunk, True)[1]:
                continue
            if dev.type != "cuda" or smem_bytes(cfg, lay) <= smem_limit(dev):
                return lay
        if dt == "float32" and not fused:
            lay = _cluster_layout(cfg, dt, dev, 0, sizes, wide=True)
            if lay:
                return lay
    raise NoLayoutError(f"no AR kernel layout of dtype {dtype!r} and "
                        f"fused={fused} fits the shared memory of a block "
                        f"on {dev}")


def cluster_arguments(cfg, greedy, c_up, noise, teacher, n_forced, w,
                      layout: Layout, log_b=None, lengths=None):
    """The cluster kernel's C arguments for one call in `layout`
    (cluster=N), its global ring and stream aside (as `ar_cluster_generate`
    takes them; the probe's entry takes the same), and the (B, T) output
    they write into. `w`: the kernel's tensors packed for the layout;
    log_b: the Laplace clip (default the config's); lengths: None for T
    steps of every row in row order, or `row_lengths`' list: the rows then
    run in `cluster_order`, and the output is zeroed first (a row is not
    written past its length).
    Raises ValueError where the packed stages are not the kernel's."""
    lib = _cluster_lib()
    B, T, C = c_up.shape
    L = len(cfg.dilations)
    O = _head_width(cfg)
    n, fused = layout.cluster, layout.fused
    if fused:
        ours = cluster_fused_stages(cfg, n, fused)
        off, lens = ((ctypes.c_int * len(ours))() for _ in range(2))
        want = lib.ar_cluster_fused_stages(
            L, cfg.residual_channels, cfg.gate_channels, cfg.skip_channels,
            C, O, n, fused, off, lens)
        if want < 0:
            raise _cluster_refusal(lib, want)
        if list(zip(off, lens)) != ours:
            raise ValueError("packed fused stages are not the kernel's")
    else:
        want = lib.ar_cluster_stage_stride(
            cfg.residual_channels, cfg.gate_channels, cfg.skip_channels, C,
            O, n)
    if w["cluster_stages"].shape[-1] != want:
        raise ValueError(f"packed stage length "
                         f"{w['cluster_stages'].shape[-1]} is not the "
                         f"kernel's {want}")
    out = (torch.empty if lengths is None else torch.zeros)(
        (B, T), dtype=torch.float32, device=c_up.device)
    shape = _cluster_shape(cfg, layout)
    args = (c_up.data_ptr(), noise.data_ptr(),
            None if teacher is None else teacher.data_ptr(), out.data_ptr(),
            *((None, None) if lengths is None else
              ((ctypes.c_int * B)(*lengths),
               (ctypes.c_int * B)(*cluster_order(lengths)))),
            *(w[k].data_ptr() for k in (
                "in_w", "in_b", "conv_b", "res_b", "skip_b", "head1_b",
                "head2_b", "cluster_stages")),
            shape[0], B, T, L, cfg.residual_channels, cfg.gate_channels,
            cfg.skip_channels, C, cfg.quantize_channels, O, n,
            int(cfg.head == "softmax"), int(greedy), n_forced, *shape[-3:],
            *(log_b or (cfg.log_b_min, cfg.log_b_max)))
    return args, out


def launch_cluster(args, device, layout: Layout, rows: int,
                   ring=None) -> None:
    """One call of the cluster kernel in `layout` on `cluster_arguments`'
    args (its output is theirs) for a batch of `rows` rows, its launches
    (one per CLUSTER_MAX_ROWS rows) counted in `launches`; ring: the wide
    form's zeroed global ring, (rows, global ring rows, R)
    (`cluster_rings`), or None; raises on a refusal or a failed launch."""
    lib = _cluster_lib()
    with torch.cuda.device(device):
        err = lib.ar_cluster_generate(
            *args, None if ring is None else ring.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise _cluster_refusal(lib, err)
    if err != 0:
        raise RuntimeError("ar_cluster launch failed: "
                           + lib.ar_cluster_error_string(err).decode())
    launches[layout.name] += -(-rows // CLUSTER_MAX_ROWS)


def _launch_cluster(cfg, greedy, c_up, noise, teacher, n_forced, w, layout,
                    lengths=None):
    args, out = cluster_arguments(cfg, greedy, c_up, noise, teacher,
                                  n_forced, w, layout, lengths=lengths)
    B = c_up.shape[0]
    shared_rows, global_rows = cluster_rings(cfg, layout)
    ring = None
    if layout.wide:
        # the wide form's global ring: zeros, so that a layer's steps
        # t < d read zeros, as from a fresh shared ring
        with span("swt.ar.rings"):
            ring = torch.zeros((B, global_rows, cfg.residual_channels),
                               dtype=DTYPES[layout.dtype],
                               device=c_up.device)
    launch_cluster(args, c_up.device, layout, B, ring=ring)
    row_bytes = B * cfg.residual_channels * DTYPES[layout.dtype].itemsize
    ring_bytes["shared"] += shared_rows * row_bytes
    ring_bytes["global"] += global_rows * row_bytes
    return out
