"""Torch WaveNet — the twin of `shallow_wavenet_tpu/models/wavenet.py`.

Same modules, names, parameter tree and casts as the flax model:
- the kernel-2 causal dilated conv is per-tap shifts + dense contractions
  (optionally one folded contraction, `fold_taps`), kernel layout
  `(k, C_in, C_out)` with `kernel[0]` the `x[t - d]` tap;
- activations run in `compute_dtype` with fp32 accumulation: a product's
  inputs are rounded to `compute_dtype`, then multiplied and summed in fp32,
  which is what `preferred_element_type=float32` does in the JAX code;
- the upsampler's repeat + SAME smoothing conv is the collapsed phase-matmul
  form, with the same weight scatter.

The weight carrier lives here too: `params_from_flax` loads a flax parameter
tree (nested numpy arrays), `extract_plain_params` gives the stacked fp32
dict the AR generator takes, and `save_params_npz`/`load_params_npz` store a
tree as a flat `.npz` (`layer0/conv/kernel`, ...).
"""

from __future__ import annotations

from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from shallow_wavenet_tpu_torch.config import ModelConfig


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _dot(x, w, dt, groups=None):
    """x @ w with both inputs rounded to `dt`, products summed in fp32.

    groups: ((rows, n), ...), the windows stacked along x's first axis, each
    `rows` rows whose first n positions are its own: each window's product
    is taken alone at its own shape, because a library GEMM sums in an
    order that depends on the shape (on the H100 a window's rows come out
    other bits inside a product of several), and positions past n are zero.
    One group is the whole product."""
    x, w = x.to(dt).float(), w.to(dt).float()
    if groups is None or len(groups) == 1:
        return torch.matmul(x, w)
    y = x.new_zeros(x.shape[:-1] + w.shape[-1:])
    r = 0
    for rows, n in groups:
        y[r:r + rows, :n] = torch.matmul(x[r:r + rows, :n], w)
        r += rows
    return y


def _sigmoid(x):
    # jax.nn.sigmoid as XLA expands it: 1 / (1 + exp(-x)), each op rounded
    # to x's dtype (under bf16 this differs from torch.sigmoid, which
    # rounds once, on about a third of the values)
    return torch.reciprocal(torch.exp(-x) + 1)


def _leaky_relu(x, slope: float = 0.1):
    # the slope is rounded to x's dtype before the product, as in JAX
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype))


class CausalDilatedConv(nn.Module):
    """Causal conv over (B, T, C) via per-tap shifts + dense contractions.

    Output t = sum_i x[t - (k-1-i)*d] @ kernel[i] + bias; left zero-padding.
    """

    def __init__(self, c_in: int, features: int, kernel_size: int = 2,
                 dilation: int = 1, dtype=torch.float32,
                 fold_taps: bool = False):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.dtype, self.fold_taps = dtype, fold_taps
        self.kernel = nn.Parameter(torch.zeros(kernel_size, c_in, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        k, d = self.kernel_size, self.dilation
        t = x.shape[1]
        xp = nn.functional.pad(x, (0, 0, (k - 1) * d, 0))
        taps = [xp[:, i * d: i * d + t] for i in range(k)]
        if self.fold_taps:
            y = _dot(torch.cat(taps, dim=-1),
                     self.kernel.reshape(-1, self.kernel.shape[-1]),
                     self.dtype)
        else:
            y = torch.zeros(x.shape[:2] + (self.kernel.shape[-1],),
                            dtype=torch.float32, device=x.device)
            for i in range(k):
                y = y + _dot(taps[i], self.kernel[i], self.dtype)
        return (y + self.bias).to(self.dtype)


class Dense1x1(nn.Module):
    """1x1 conv == position-wise dense, fp32 accumulation."""

    def __init__(self, c_in: int, features: int, dtype=torch.float32,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(c_in, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, groups=None):
        y = _dot(x, self.kernel, self.dtype, groups)
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class Embed(nn.Module):
    """flax `nn.Embed`: an fp32 `embedding` table indexed by integer ids."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features))

    def forward(self, ids):
        return self.embedding[ids.long()]


class ResidualBlock(nn.Module):
    """Gated unit: z = tanh(Wf*x + Vf.c) * sigmoid(Wg*x + Vg.c); 1x1 to
    residual (add) and 1x1 to skip."""

    def __init__(self, residual_channels: int, gate_channels: int,
                 skip_channels: int, cond_channels: int, kernel_size: int,
                 dilation: int, dtype=torch.float32, fold_taps: bool = False):
        super().__init__()
        half = gate_channels // 2
        self.conv = CausalDilatedConv(residual_channels, gate_channels,
                                      kernel_size, dilation, dtype, fold_taps)
        self.cond = Dense1x1(cond_channels, gate_channels, dtype,
                             use_bias=False)
        self.res = Dense1x1(half, residual_channels, dtype)
        self.skip = Dense1x1(half, skip_channels, dtype)

    def forward(self, x, c):
        h = self.conv(x) + self.cond(c)
        half = h.shape[-1] // 2
        z = torch.tanh(h[..., :half]) * _sigmoid(h[..., half:])
        return x + self.res(z), self.skip(z)


class RepeatSmoothStage(nn.Module):
    """repeat(f) + SAME conv(kernel 2f+1) without materializing the repeat:
    output[i*f + p] = sum_m A[p, m] @ c[i + m], m in {-1, 0, 1}, with
    A[p, m] = sum of the conv taps j that land in frame i + m. The parameter
    tree (kernel (2f+1, C, C), bias (C,)) is that of the plain conv."""

    def __init__(self, factor: int, c_in: int, channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.factor, self.dtype = factor, dtype
        self.kernel = nn.Parameter(torch.zeros(2 * factor + 1, c_in, channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def phase_weights(self):
        """(3C, f*C) phase-matmul weights; the taps are summed in the same
        order as the JAX scatter, so the fp32 sums are identical."""
        f = self.factor
        k, c_in, ch = self.kernel.shape
        zero = torch.zeros(c_in, ch, dtype=self.kernel.dtype,
                           device=self.kernel.device)
        a = [[zero] * f for _ in range(3)]
        for p in range(f):
            for j in range(k):
                m = (p - f + j) // f
                a[m + 1][p] = a[m + 1][p] + self.kernel[j]
        w2 = torch.stack([torch.stack(row) for row in a])   # (3, f, C, ch)
        return w2.permute(0, 2, 1, 3).reshape(3 * c_in, f * ch)

    def forward(self, c, w=None, groups=None):
        """w: this stage's `phase_weights()`, made beforehand; None builds
        them here. groups: as `_dot`'s, in c's frames."""
        b_sz, n_fr, _ = c.shape
        cp = nn.functional.pad(c, (0, 0, 1, 1))   # conv SAME zero pad
        nb = torch.cat([cp[:, :-2], cp[:, 1:-1], cp[:, 2:]], dim=-1)
        y = _dot(nb, self.phase_weights() if w is None else w, self.dtype,
                 groups)
        y = y.reshape(b_sz, n_fr * self.factor, -1) + self.bias
        return y.to(self.dtype)


class ConditioningUpsampler(nn.Module):
    """Frame-rate features -> sample-rate conditioning: 1x1 projection, then
    per-stage repeat + smoothing (RepeatSmoothStage), leaky-ReLU after each.
    `valid` (B,) zeroes each row past its own length after every stage,
    which equals upsampling a row that truly ends there. `phase`: every
    stage's phase weights (`phase_weights()`), made once by a caller whose
    weights stay fixed (serving); without them each call builds them
    (hundreds of small ops at config 2's factors), as training needs.
    `windows`: ((rows, frames), ...), the windows stacked in c (each
    right-padded, with `valid` its frames): every product is taken per
    window at the window's own shape (`_dot`), so a window gets the bits it
    gets upsampled alone, and all else runs once over the stack."""

    def __init__(self, factors, aux_channels: int, channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.factors = tuple(factors)
        self.proj = Dense1x1(aux_channels, channels, dtype)
        for si, f in enumerate(self.factors):
            self.add_module(f"smooth{si}",
                            RepeatSmoothStage(f, channels, channels, dtype))

    def stages(self):
        return [getattr(self, f"smooth{si}")
                for si in range(len(self.factors))]

    def phase_weights(self):
        """Every stage's `phase_weights()`, for `forward(phase=)`."""
        return tuple(stage.phase_weights() for stage in self.stages())

    def forward(self, c, valid=None, phase=None, windows=None):
        def groups(rate):
            return (None if windows is None
                    else [(rows, frames * rate) for rows, frames in windows])

        def mask(x, rate):
            if valid is None:
                return x
            pos = torch.arange(x.shape[1], device=x.device)[None, :, None]
            keep = pos < (valid.to(x.device) * rate)[:, None, None]
            return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))

        c = mask(_leaky_relu(self.proj(c, groups(1))), 1)
        rate = 1
        for si, stage in enumerate(self.stages()):
            c = stage(c, None if phase is None else phase[si], groups(rate))
            rate *= stage.factor
            c = mask(_leaky_relu(c), rate)
        return c


class WaveNet(nn.Module):
    """Shallow/deep WaveNet vocoder.

    forward(x_prev, cond, speaker) -> head outputs (B, T, out_dim):
      x_prev : (B, T) previous samples in [-1, 1], or int mu-law class ids
               for the softmax head
      cond   : (B, F, aux) frame features, F * prod(upsample_factors) >= T + 1;
               position i uses c_up[i + 1] (x_prev is x shifted right by one)
      speaker: (B,) int ids (used only when cfg.n_speakers > 0)

    Parameters start at zero: load them with `params_from_flax`.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg.compute_dtype)
        self._dt = dt
        R, S = cfg.residual_channels, cfg.skip_channels
        self.upsampler = ConditioningUpsampler(
            cfg.upsample_factors, cfg.aux_channels, cfg.cond_channels, dt)
        if cfg.n_speakers > 0:
            self.speaker_embed = Embed(cfg.n_speakers, cfg.cond_channels)
        if cfg.head == "softmax":
            self.input_embed = Embed(cfg.quantize_channels, R)
        else:
            self.input_proj = Dense1x1(1, R, dt)
        for li, d in enumerate(cfg.dilations):
            self.add_module(f"layer{li}", ResidualBlock(
                R, cfg.gate_channels, S, cfg.cond_channels, cfg.kernel_size,
                d, dt, cfg.fold_taps))
        self.head1 = Dense1x1(S, S, dt)
        out_dim = cfg.quantize_channels if cfg.head == "softmax" else 2
        self.head2 = Dense1x1(S, out_dim, torch.float32)

    def layers(self):
        return [getattr(self, f"layer{li}")
                for li in range(len(self.cfg.dilations))]

    def forward(self, x_prev, cond, speaker=None):
        t = x_prev.shape[1]
        c_up = self.upsample_cond(cond, speaker)
        c_up = c_up[:, 1: t + 1].to(self._dt)
        return self.stack(x_prev, c_up)

    def stack(self, x_prev, c_up):
        """Conv stack + head over inputs already aligned at sample rate."""
        if self.cfg.head == "softmax":
            h = self.input_embed(x_prev).to(self._dt)
        else:
            h = self.input_proj(x_prev[..., None])
        skips = torch.zeros(h.shape[:2] + (self.cfg.skip_channels,),
                            dtype=torch.float32, device=h.device)
        for layer in self.layers():
            h, s = layer(h, c_up)
            skips = skips + s.float()
        out = torch.relu(skips.to(self._dt))
        out = torch.relu(self.head1(out))
        return self.head2(out).float()

    def upsample_cond(self, cond, speaker=None, valid_frames=None,
                      phase=None, windows=None):
        """Sample-rate conditioning (B, F*hop, C) fp32, precomputed before AR
        generation. valid_frames: optional (B,) valid input-frame counts;
        phase: the upsampler's phase weights, made once
        (`ConditioningUpsampler.phase_weights`), or None; windows: the
        stacked windows' (rows, frames), or None (`ConditioningUpsampler`)."""
        cfg = self.cfg
        c_up = self.upsampler(cond, valid_frames, phase, windows)
        if cfg.n_speakers > 0:
            if speaker is None:
                raise ValueError("speaker ids required when n_speakers > 0")
            emb = self.speaker_embed(speaker)
            c_up = c_up + emb[:, None, :].to(self._dt)
            if valid_frames is not None:
                hop = int(np.prod(cfg.upsample_factors))
                pos = torch.arange(c_up.shape[1],
                                   device=c_up.device)[None, :, None]
                keep = pos < (valid_frames.to(c_up.device) * hop)[:, None, None]
                c_up = torch.where(keep, c_up, torch.zeros(
                    (), dtype=c_up.dtype, device=c_up.device))
        return c_up.float()


# ---------------------------------------------------------------------------
# The weight carrier
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def params_from_flax(module: WaveNet, tree) -> WaveNet:
    """Load a flax parameter tree (nested dicts of arrays, as
    `jax.device_get(variables["params"])` gives) into `module`. Every
    parameter must be present with its flax shape."""
    state = {k.replace("/", "."): torch.from_numpy(
                 np.array(v, dtype=np.float32, copy=True))
             for k, v in _flatten(tree).items()}
    module.load_state_dict(state, strict=True)
    return module


def extract_plain_params(module: WaveNet) -> dict:
    """Stacked fp32 tensors for the AR generator (the layout of the JAX
    `extract_plain_params`):

      conv_w (L, k, R, G), conv_b (L, G), cond_w (L, C, G),
      res_w (L, G/2, R), res_b (L, R), skip_w (L, G/2, S), skip_b (L, S),
      input_embed (Q, R) or input_w (1, R) + input_b (R,),
      head1_w (S, S), head1_b (S,), head2_w (S, O), head2_b (O,)
    """
    layers = module.layers()

    def stack(get):
        return torch.stack([get(lp).detach().float() for lp in layers])

    out = {
        "conv_w": stack(lambda lp: lp.conv.kernel),
        "conv_b": stack(lambda lp: lp.conv.bias),
        "cond_w": stack(lambda lp: lp.cond.kernel),
        "res_w": stack(lambda lp: lp.res.kernel),
        "res_b": stack(lambda lp: lp.res.bias),
        "skip_w": stack(lambda lp: lp.skip.kernel),
        "skip_b": stack(lambda lp: lp.skip.bias),
        "head1_w": module.head1.kernel, "head1_b": module.head1.bias,
        "head2_w": module.head2.kernel, "head2_b": module.head2.bias,
    }
    if module.cfg.head == "softmax":
        out["input_embed"] = module.input_embed.embedding
    else:
        out["input_w"] = module.input_proj.kernel
        out["input_b"] = module.input_proj.bias
    return {k: v.detach().float().contiguous() for k, v in out.items()}


def save_params_npz(path, tree) -> None:
    """Write a flax parameter tree as a flat .npz (`layer0/conv/kernel`)."""
    flat = {k: np.asarray(v, np.float32) for k, v in _flatten(tree).items()}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_params_npz(path) -> dict:
    """Read a tree written by `save_params_npz` (nested dicts of numpy)."""
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def init_params_tree(cfg: ModelConfig, seed: int = 0) -> dict:
    """A random flax-layout parameter tree from numpy: lecun-normal kernels
    (std 1/sqrt(fan_in)), small random biases, unit-variance embeddings.
    `head2` is zero as in the flax init; callers that need a head with
    signal randomize it."""
    rng = np.random.default_rng(seed)
    R, G, S = cfg.residual_channels, cfg.gate_channels, cfg.skip_channels
    C, half = cfg.cond_channels, cfg.gate_channels // 2

    def dense(c_in, c_out, bias=True, k=None):
        shape = (c_in, c_out) if k is None else (k, c_in, c_out)
        fan_in = c_in * (1 if k is None else k)
        node = {"kernel": (rng.standard_normal(shape)
                           / np.sqrt(fan_in)).astype(np.float32)}
        if bias:
            node["bias"] = (0.01 * rng.standard_normal(c_out)
                            ).astype(np.float32)
        return node

    up = {"proj": dense(cfg.aux_channels, C)}
    for si, f in enumerate(cfg.upsample_factors):
        up[f"smooth{si}"] = dense(C, C, k=2 * f + 1)
    tree = {"upsampler": up}
    if cfg.n_speakers > 0:
        tree["speaker_embed"] = {"embedding": rng.standard_normal(
            (cfg.n_speakers, C)).astype(np.float32)}
    if cfg.head == "softmax":
        tree["input_embed"] = {"embedding": rng.standard_normal(
            (cfg.quantize_channels, R)).astype(np.float32)}
    else:
        tree["input_proj"] = dense(1, R)
    for li in range(len(cfg.dilations)):
        tree[f"layer{li}"] = {
            "conv": dense(R, G, k=cfg.kernel_size),
            "cond": dense(C, G, bias=False),
            "res": dense(half, R),
            "skip": dense(half, S),
        }
    tree["head1"] = dense(S, S)
    out_dim = cfg.quantize_channels if cfg.head == "softmax" else 2
    tree["head2"] = {"kernel": np.zeros((S, out_dim), np.float32),
                     "bias": np.zeros(out_dim, np.float32)}
    return tree
