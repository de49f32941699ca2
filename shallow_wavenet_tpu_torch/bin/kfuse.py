"""Step time of the AR kernel's fused window against its unfused form — the
counterpart of the TPU timing prototype `tools/kfuse.py`.

    python3 -m shallow_wavenet_tpu_torch.bin.kfuse [--preset shallow_laplace_single] \\
        [--dtype float32] [--batches 1,8,32] [--windows 0,2,3,4,6] \\
        [--steps 2048] [--kernel cluster|ar_generate]

The prototype's kernel computes the production kernel's function on a
recipe of weights: every weight normal with std 0.05 from
`np.random.default_rng(0)`, the input encoded as x * 1 + in_b (unit input
weights), zero biases elsewhere, and the config's log-scale clip. Here the
same recipe runs through the port's own CUDA kernels (`ops.ar_kernel`; one
launch per call), unfused for W = 0 and the fused window otherwise, on
random normal conditioning and uniforms, each W on the layout the decode
would pick for it (`bin.decode.kernel_layout`): with --kernel cluster (the
default) the cluster kernel at the size the decode picks for that W, or
ar_generate where no cluster fits; with --kernel ar_generate the
one-SM-per-row kernel alone (`cluster=False`; a preset whose resident
rings do not fit runs streamed). Prints one JSON line per (B, W): mean us
per sample step by CUDA events over --reps calls after one warm-up call,
RTF at the preset's sample rate, the weights the kernel reads per step,
the layout and the kernel variant (`ar_kernel.variant`). Needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from shallow_wavenet_tpu_torch.bin.decode import kernel_layout
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.ops import ar_kernel

# the prototype's chunk: it divides its per-step time by the whole T, so T
# must be whole chunks (the CUDA kernel has no chunk grid; this only keeps
# the two tools' step counts alike)
PROTOTYPE_CHUNK = 64


def recipe_params(cfg, device) -> dict:
    """The prototype's weights as plain params (Laplace head)."""
    rng = np.random.default_rng(0)
    L, R, G = len(cfg.dilations), cfg.residual_channels, cfg.gate_channels
    S, C, half = cfg.skip_channels, cfg.cond_channels, G // 2

    def mk(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * 0.05).astype(np.float32))

    def zeros(*shape):
        return torch.zeros(shape)

    pp = {"input_w": torch.ones(1, R), "input_b": mk(R),
          "conv_w": mk(L, 2, R, G), "conv_b": zeros(L, G),
          "cond_w": mk(L, C, G), "res_w": mk(L, half, R),
          "res_b": zeros(L, R), "skip_w": mk(L, half, S),
          "skip_b": zeros(L, S), "head1_w": mk(S, S), "head1_b": zeros(S),
          "head2_w": mk(S, 2), "head2_b": zeros(2)}
    return {k: v.to(device) for k, v in pp.items()}


def weights_per_step(cfg, fused: int) -> int:
    """Weights the kernel reads per sample step (in elements)."""
    L, R, G = len(cfg.dilations), cfg.residual_channels, cfg.gate_channels
    S, C, half = cfg.skip_channels, cfg.cond_channels, G // 2
    n = L * (2 * R * G + C * G + G + R + S) + S * S + S + 2 * S + 2 + 2 * R
    n += L * half * (S + R)
    if fused:
        for blk in ar_kernel.fused_blocks(L, fused):
            n += half * G * len(blk) * (len(blk) - 1) // 2
    return n


KERNELS = ("cluster", "ar_generate")


def sweep(preset: str = "shallow_laplace_single", dtype: str = "float32",
          batches=(1, 8, 32), windows=(0, 2, 3, 4, 6), steps: int = 2048,
          reps: int = 3, device=None, kernel: str = "cluster"):
    """Rows {"B", "W", "us_per_step", "rtf", "weights", "layout",
    "variant"} for every (B, W), on `kernel` (one of KERNELS)."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if steps % PROTOTYPE_CHUNK != 0:
        raise ValueError(f"steps={steps} must be a multiple of "
                         f"{PROTOTYPE_CHUNK}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("kfuse times the CUDA kernel; it needs CUDA")
    cfg = get_config(preset)
    mc = dataclasses.replace(cfg.model, head="laplace")
    sr = cfg.data.sample_rate
    pp = recipe_params(mc, dev)
    layouts = {W: kernel_layout(mc, dtype, dev, fused=W,
                                cluster=kernel == "cluster")
               for W in windows}
    # made once per W, so that a timed call is the kernel's launch alone
    weights = {W: ar_kernel.kernel_weights(pp, mc, dtype, W, dev,
                                           layouts[W]["cluster"])
               for W in windows}
    rng = np.random.default_rng(0)
    rows = []
    for B in batches:
        c_up = torch.from_numpy(rng.standard_normal(
            (B, steps, mc.cond_channels)).astype(np.float32)).to(dev)
        noise = torch.from_numpy(rng.uniform(0.01, 0.99, (B, steps)).astype(
            np.float32)).to(dev)
        for W in windows:
            def call():
                return ar_kernel.generate(weights[W], mc, c_up, noise=noise,
                                          device=dev, **layouts[W])

            call()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(reps):
                call()
            end.record()
            torch.cuda.synchronize()
            us = 1e3 * start.elapsed_time(end) / reps / steps
            lay = layouts[W]
            n = lay["cluster"]
            rows.append({"B": B, "W": W, "us_per_step": us,
                         "rtf": us * 1e-6 * sr,
                         "weights": weights_per_step(mc, W),
                         "layout": lay,
                         "variant": ar_kernel.variant(
                             dtype, lay["stream"], W, n, bool(n) and
                             ar_kernel.cluster_resident(mc, dtype, n, dev,
                                                        W))})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="shallow_laplace_single")
    p.add_argument("--dtype", default="float32", choices=ar_kernel.DTYPES)
    p.add_argument("--batches", default="1,8,32")
    p.add_argument("--windows", default="0,2,3,4,6")
    p.add_argument("--steps", type=int, default=2048)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--kernel", default="cluster", choices=KERNELS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kfuse: CUDA is not available", file=sys.stderr)
        return 1
    for row in sweep(args.preset, args.dtype,
                     [int(b) for b in args.batches.split(",")],
                     [int(w) for w in args.windows.split(",")],
                     args.steps, args.reps, kernel=args.kernel):
        print(json.dumps({"preset": args.preset, "dtype": args.dtype,
                          "kernel": args.kernel,
                          "device": torch.cuda.get_device_name(0), **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
