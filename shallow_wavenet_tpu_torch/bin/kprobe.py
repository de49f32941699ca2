"""Per-step time of the AR step's ablations on the card — the counterpart of
the TPU ablation probe `tools/kprobe.py`.

    python3 -m shallow_wavenet_tpu_torch.bin.kprobe [--preset shallow_laplace_single] \\
        [--dtype float32] [--batches 1,8,32] [--steps 2048] [--chunk 128] \\
        [--only full,no_cond] [--reps 3]

Every ablation (`ops.ar_probe.ABLATIONS`, or those --only names) runs the
probe kernel on the TPU probe's recipe of weights (`probe_weights`, seed
0), random normal conditioning and uniforms in (0.01, 0.99), one launch per
call. Prints one JSON line per (B, ablation): the mean us per sample step
by CUDA events over --reps calls after one warm-up call, the saving against
`full` at the same B, and the weights the variant reads per step (in
elements; no_cond's conditioning weights counted once per chunk). An
ablation the shape or the card cannot take is printed with the error that
refused it before launch (`no_resskip` where S > G/2, `split2` at an odd
batch, a preset whose resident rings do not fit one block), as the TPU tool
prints FAILED; nothing runs in its place. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.ops import ar_probe
from shallow_wavenet_tpu_torch.ops.ar_kernel import DTYPES


def weights_per_step(cfg, ablate: str, chunk: int) -> float:
    """Weights the probe kernel reads per sample step (in elements)."""
    L, R, G = len(cfg.dilations), cfg.residual_channels, cfg.gate_channels
    S, C, half = cfg.skip_channels, cfg.cond_channels, G // 2
    cond, proj, head = L * C * G, L * half * (S + R), S * S + 2 * S
    n = R + L * 2 * R * G + cond + proj + head
    if ablate in ("no_cond", "matmuls_only"):
        n -= cond * (chunk - 1) / chunk
    if ablate == "no_prev":
        n -= L * R * G
    if ablate == "no_resskip":
        n -= proj
    if ablate == "no_head":
        n -= head
    return float(n)


def sweep(preset: str = "shallow_laplace_single", dtype: str = "float32",
          batches=(1, 8, 32), steps: int = 2048, chunk: int = 128,
          only=None, reps: int = 3, device=None, outputs=None):
    """Rows {"B", "ablate", "us_per_step", "saves_us", "weights_per_step"},
    or {"B", "ablate", "error"} for an ablation refused before launch, for
    every (B, ablation). outputs: a dict to fill with what each B ran,
    {B: {"cond": ..., "noise": ..., ablate: samples of its first call}},
    so that a caller can check the timed calls."""
    if chunk < 4 or chunk % 4 or steps % chunk:
        raise ValueError(f"steps={steps} must be whole chunks of a multiple "
                         f"of 4, got chunk={chunk}")
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
    abls = tuple(only) if only else ar_probe.ABLATIONS
    unknown = [a for a in abls if a not in ar_probe.ABLATIONS]
    if unknown:
        raise ValueError(f"unknown ablations {unknown}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("kprobe times the CUDA kernel; it needs CUDA")
    cfg = get_config(preset).model
    w = {k: v.to(dev) for k, v in ar_probe.probe_weights(cfg, dtype).items()}
    rng = np.random.default_rng(0)
    rows = []
    for B in batches:
        cond = torch.from_numpy(rng.standard_normal(
            (steps, B, cfg.cond_channels)).astype(np.float32)).to(dev)
        noise = torch.from_numpy(rng.uniform(0.01, 0.99, (steps, B)).astype(
            np.float32)).to(dev)
        base = None
        if outputs is not None:
            outputs[B] = {"cond": cond, "noise": noise}
        for ab in abls:
            def call():
                return ar_probe.probe(w, cfg, cond, noise, ab, chunk, dev)

            try:
                out = call()
            except ValueError as e:
                rows.append({"B": B, "ablate": ab, "error": str(e)})
                continue
            if outputs is not None:
                outputs[B][ab] = out
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(reps):
                call()
            end.record()
            torch.cuda.synchronize()
            us = 1e3 * start.elapsed_time(end) / reps / steps
            if ab == "full":
                base = us
            rows.append({"B": B, "ablate": ab, "us_per_step": us,
                         "saves_us": None if base is None else base - us,
                         "weights_per_step": weights_per_step(cfg, ab,
                                                              chunk)})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="shallow_laplace_single")
    p.add_argument("--dtype", default="float32", choices=DTYPES)
    p.add_argument("--batches", default="1,8,32")
    p.add_argument("--steps", type=int, default=2048)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--only", default="")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kprobe: CUDA is not available", file=sys.stderr)
        return 1
    for row in sweep(args.preset, args.dtype,
                     [int(b) for b in args.batches.split(",")], args.steps,
                     args.chunk, [a for a in args.only.split(",") if a],
                     args.reps):
        print(json.dumps({"preset": args.preset, "dtype": args.dtype,
                          "T": args.steps, "chunk": args.chunk,
                          "device": torch.cuda.get_device_name(0), **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
