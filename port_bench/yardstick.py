"""The benchmark's arithmetic: the card's peaks, a kernel call's least time,
and the model's operation counts.

Copied from `chip_smoke.py` (`bound`, `train_flops`, the peaks) so that the
yardstick stays fixed while the program changes. Nothing here imports the
program. Every count takes a model configuration as a plain mapping with the
keys of the port's `ModelConfig` (`dilations` computed from `n_stacks` and
`stack_size`), so the same numbers come out whatever implements the model.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
PEAK_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12         # bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12             # HBM3 bytes per second
PEAKS = {"float32": PEAK_FP32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}
# the most a kernel can keep on the card between steps: 50 MiB of L2 and,
# on each of the 132 SMs, 256 KiB of L1 / shared memory and 256 KiB of
# registers (121,634,816 bytes)
ON_CHIP_BYTES = 50 * 2 ** 20 + 132 * (256 + 256) * 2 ** 10


def dilations(mc) -> list[int]:
    return [2 ** i for _ in range(mc["n_stacks"])
            for i in range(mc["stack_size"])]


def _widths(mc):
    L = len(dilations(mc))
    R, G = mc["residual_channels"], mc["gate_channels"]
    S, C = mc["skip_channels"], mc["cond_channels"]
    O = mc["quantize_channels"] if mc["head"] == "softmax" else 2
    return L, R, G, S, C, O


def ar_step_macs(mc) -> int:
    """Multiply-adds of one unfused AR step for one row, as chip_smoke's
    `bound` counts them: per layer both taps R x G, the conditioning C x G,
    skip and residual (G/2) x (S + R); the head S x S + S x O. The fused
    window's extra products are one implementation's work, not the
    model's, and are left out."""
    L, R, G, S, C, O = _widths(mc)
    return L * (2 * R * G + C * G + (G // 2) * (S + R)) + S * S + S * O


def ar_weight_count(mc) -> int:
    """Parameters the AR kernel reads (the plain params' tensors: conv,
    cond, residual, skip, the head and the input projection or the softmax
    embedding)."""
    L, R, G, S, C, O = _widths(mc)
    half = G // 2
    per_layer = 2 * R * G + G + C * G + half * R + R + half * S + S
    inp = mc["quantize_channels"] * R if mc["head"] == "softmax" else 2 * R
    return L * per_layer + S * S + S + S * O + O + inp


def ar_bound_ms(mc, B: int, T: int, weight_bytes: int = 4,
                dtype: str = "float32", lengths=None) -> tuple[float, str]:
    """Least time (ms) of one AR kernel call of B rows and T steps, or of
    rows that run `lengths` steps each (at most T): its operations over
    the peak of `dtype`, or its bytes over the memory rate, whichever is
    larger. The operations and the per-step streams (c_up, noise, out,
    fp32) count the steps the rows run; the weights are read once, and
    the part of them beyond what the card can hold on chip
    (`ON_CHIP_BYTES`) once more for each step of the longest row after
    its first, since no kernel can keep it there. Returns (ms,
    "operations" or "bytes")."""
    C = mc["cond_channels"]
    steps = B * T if lengths is None else sum(lengths)
    longest = T if lengths is None else max(lengths)
    w_bytes = weight_bytes * ar_weight_count(mc)
    flops = 2.0 * ar_step_macs(mc) * steps
    nbytes = (4.0 * (steps * C + 2 * steps) + w_bytes
              + (longest - 1) * max(0, w_bytes - ON_CHIP_BYTES))
    t_ops, t_bytes = flops / PEAKS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def hop(mc) -> int:
    return math.prod(mc["upsample_factors"])


def stack_macs_per_sample(mc) -> int:
    """Multiply-adds of the conv stack and head for one position (the
    input projection included), as chip_smoke's `train_flops` counts."""
    L, R, G, S, C, O = _widths(mc)
    inp = 0 if mc["head"] == "softmax" else R
    return (inp + L * (mc["kernel_size"] * R * G + C * G + (G // 2) * (R + S))
            + S * S + S * O)


def upsampler_macs(mc, frames: int) -> tuple[int, int]:
    """(multiply-adds of the upsampler over `frames` input frames, those of
    its 1x1 projection alone): the projection, then each stage's phase
    matmul, 3C x fC per input frame of the stage."""
    C = mc["cond_channels"]
    proj = frames * mc["aux_channels"] * C
    total, f_in = proj, frames
    for f in mc["upsample_factors"]:
        total += f_in * 3 * C * f * C
        f_in *= f
    return total, proj


def decode_flops(mc, samples: int, frames: int) -> float:
    """Model FLOPs of delivering `samples` samples from `frames` frames:
    one stack step per sample and the upsampler over the frames."""
    return 2.0 * (samples * stack_macs_per_sample(mc)
                  + upsampler_macs(mc, frames)[0])


def train_flops(mc, B: int, T: int) -> float:
    """FLOPs of one update at B rows of T samples (x is (B, T)), a copy of
    chip_smoke's `train_flops`: the stack over T - 1 positions and the
    upsampler over T / hop frames; backward is twice the forward's
    products, less the input gradients nobody needs (of x's projection and
    of cond's)."""
    t = T - 1
    stack = stack_macs_per_sample(mc)
    inp = 0 if mc["head"] == "softmax" else mc["residual_channels"]
    ups, proj = upsampler_macs(mc, T // hop(mc))
    fwd = B * (t * stack + ups)
    bwd = 2 * fwd - B * (t * inp + proj)
    return 2.0 * (fwd + bwd)

