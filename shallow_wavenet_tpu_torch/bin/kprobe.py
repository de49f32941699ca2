"""Per-step time of the AR step's ablations on the card — the counterpart of
the TPU ablation probe `tools/kprobe.py` — and the cluster kernel's
per-stage timer.

    python3 -m shallow_wavenet_tpu_torch.bin.kprobe [--preset shallow_laplace_single] \\
        [--dtype float32] [--batches 1,8,32] [--steps 2048] [--chunk 128] \\
        [--only full,no_cond] [--reps 3] [--kernel generate|cluster] \\
        [--split N] [--weights-l2] [--timer] [--fused 4]

Every ablation (`ops.ar_probe.ABLATIONS`, with --kernel cluster
`CLUSTER_ABLATIONS`, or those --only names) runs the probe kernel on the
TPU probe's recipe of weights (`probe_weights`, seed 0), random normal
conditioning and uniforms in (0.01, 0.99), one launch per call:
--kernel generate (the default) on `csrc/ar_probe.cu`, ar_generate's body;
--kernel cluster on `csrc/ar_cluster.cu`'s probe instances, at the N and
weight placement the decode picks (or --split, --weights-l2). Prints one
JSON line per (B, ablation): the mean us per sample step by CUDA events
over --reps calls after one warm-up call, the saving against `full` at
the same B, and the weights the variant reads per step (in elements;
no_cond's conditioning weights counted once per chunk). An ablation the
shape or the card cannot take is printed with the error that refused it
before launch (`no_resskip` where S > G/2, `split2` at an odd batch or on
the cluster kernel, a preset whose resident rings do not fit one block),
as the TPU tool prints FAILED; nothing runs in its place.

--timer runs the cluster kernel's timed instance instead, at
the decode's layout, unfused and with the fused window --fused W, at the
largest of --batches, for --dtype (or both dtypes with --dtype both): one
JSON line per (dtype, form) with the untimed and timed us per step in
turns, the timed samples' equality with the production launch's, the
timed instance's form (`form`: it runs row k on cluster k for T steps,
where production reads each cluster's row and steps from the launch, so
the stage table is of that form) and the stage table
(`ar_probe.stage_times`). Needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.ops import ar_kernel, ar_probe
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


def _event_ms(fn) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def sweep(preset: str = "shallow_laplace_single", dtype: str = "float32",
          batches=(1, 8, 32), steps: int = 2048, chunk: int = 128,
          only=None, reps: int = 3, device=None, outputs=None,
          kernel: str = "generate", split=None, weights_l2: bool = False):
    """Rows {"B", "ablate", "us_per_step", "saves_us", "weights_per_step"},
    or {"B", "ablate", "error"} for an ablation refused before launch, for
    every (B, ablation), on `kernel` (one of `ar_probe.KERNELS`; the
    cluster kernel at `split` ranks, or the decode's size where None,
    placed as the decode places it, `ar_kernel.choose_layout`, or its
    weights from L2 with `weights_l2`). outputs: a dict to fill with what
    each B ran, {B: {"cond": ..., "noise": ..., ablate: samples of its
    first call}}, so that a caller can check the timed calls."""
    if kernel not in ar_probe.KERNELS:
        raise ValueError(f"kernel must be one of {ar_probe.KERNELS}, got "
                         f"{kernel!r}")
    if chunk < 4 or chunk % 4 or steps % chunk:
        raise ValueError(f"steps={steps} must be whole chunks of a multiple "
                         f"of 4, got chunk={chunk}")
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}")
    known = (ar_probe.ABLATIONS if kernel == "generate"
             else ar_probe.CLUSTER_ABLATIONS)
    abls = tuple(only) if only else known
    unknown = [a for a in abls if a not in ar_probe.ALL_ABLATIONS]
    if unknown:
        raise ValueError(f"unknown ablations {unknown}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("kprobe times the CUDA kernel; it needs CUDA")
    cfg = get_config(preset).model
    w = {k: v.to(dev) for k, v in ar_probe.probe_weights(cfg, dtype).items()}
    placed = {}
    kw = {}
    if kernel == "cluster":
        layout = ar_kernel.choose_layout(
            cfg, dtype, dev, cluster=True if split is None else split)
        if weights_l2:
            layout = dataclasses.replace(layout, resident=False)
        placed = {"N": layout.cluster,
                  "weights": "shared memory" if layout.resident else "L2"}
        kw = dict(kernel=kernel, layout=layout,
                  packed=ar_probe.cluster_weights(w, cfg, layout, dev))
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
                return ar_probe.probe(w, cfg, cond, noise, ab, chunk, dev,
                                      **kw)

            try:
                out = call()
            except ValueError as e:
                rows.append({"B": B, "ablate": ab, "error": str(e)})
                continue
            if outputs is not None:
                outputs[B][ab] = out
            us = 1e3 * _event_ms(lambda: [call() for _ in range(reps)]) \
                / reps / steps
            if ab == "full":
                base = us
            rows.append({"B": B, "ablate": ab, **placed, "us_per_step": us,
                         "saves_us": None if base is None else base - us,
                         "weights_per_step": weights_per_step(cfg, ab,
                                                              chunk)})
    return rows


def time_stages(pp, cfg, c_up, noise, dtype: str = "float32",
                fused: int = 0, device=None) -> dict:
    """The cluster kernel's timer at the decode's layout for (dtype,
    fused) on c_up (B, T, C) and noise (B, T): the production launch and
    the timed instance on the same prepared arguments, in turns (untimed,
    timed, timed, untimed; us per step each), whether the timed samples
    equal the production launch's, the timed/untimed ratio of their means,
    and the stage table of the last timed call (`ar_probe.stage_times`).
    pp: plain params, or their KernelWeights for this layout."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("the timer runs on the card; it needs CUDA")
    layout = ar_kernel.choose_layout(cfg, dtype, dev, fused)
    w = ar_kernel.kernel_weights(pp, cfg, layout, dev)
    args, out, timer, layout = ar_probe.timed_arguments(
        w, cfg, c_up, noise, layout, dev)
    n, resident = layout.cluster, layout.resident
    B, T, _ = c_up.shape

    def run(kind):
        if kind == "untimed":
            ar_kernel.launch_cluster(args, dev, layout, B)
        else:
            ar_probe.launch_timed(args, timer, layout)

    run("untimed")
    plain = out.clone()
    run("timed")
    equal = bool(torch.equal(out, plain))
    us, ms = {"untimed": [], "timed": []}, 0.0
    for kind in ("untimed", "timed", "timed", "untimed"):
        ms = _event_ms(lambda: run(kind))
        us[kind].append(1e3 * ms / T)
    # the last call was untimed: the timer holds the last timed call's
    # cycles, whose time is the second timed turn's
    return {"dtype": dtype, "fused": fused, "B": B, "T": T, "N": n,
            "weights": "shared memory" if resident else "L2",
            "variant": ar_probe.variant(dtype, "timed", "cluster", n,
                                        resident, fused),
            "us_untimed": us["untimed"], "us_timed": us["timed"],
            "ratio": sum(us["timed"]) / sum(us["untimed"]),
            "equal": equal, "form": ar_probe.TIMED_FORM,
            "stages": ar_probe.stage_times(timer, 1e-3 * T * us["timed"][-1],
                                           T, fused)}


def timer_sweep(preset: str = "shallow_laplace_single", dtypes=("float32",),
                batch: int = 8, steps: int = 2048, fused: int = 4,
                device=None):
    """`time_stages` for each dtype, unfused and with the fused window
    `fused`, at the decode's layouts, on the probe's recipe of weights
    (`plain_params(probe_weights(...))`), random normal conditioning and
    uniforms in (0.01, 0.99) at (batch, steps)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("the timer runs on the card; it needs CUDA")
    if fused < 1:
        raise ValueError(f"fused must be >= 1, got {fused}")
    cfg = get_config(preset).model
    rng = np.random.default_rng(0)
    c_up = torch.from_numpy(rng.standard_normal(
        (batch, steps, cfg.cond_channels)).astype(np.float32)).to(dev)
    noise = torch.from_numpy(rng.uniform(0.01, 0.99, (batch, steps)).astype(
        np.float32)).to(dev)
    return [time_stages(ar_probe.plain_params(ar_probe.probe_weights(
                cfg, dt)), cfg, c_up, noise, dt, W, dev)
            for dt in dtypes for W in (0, fused)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="shallow_laplace_single")
    p.add_argument("--dtype", default="float32",
                   choices=(*DTYPES, "both"))
    p.add_argument("--batches", default="1,8,32")
    p.add_argument("--steps", type=int, default=2048)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--only", default="")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--kernel", default="generate", choices=ar_probe.KERNELS)
    p.add_argument("--split", type=int, default=None,
                   help="the cluster kernel's N (default: the decode's)")
    p.add_argument("--weights-l2", action="store_true",
                   help="stream the cluster kernel's weights from L2")
    p.add_argument("--timer", action="store_true",
                   help="the cluster kernel's per-stage timer")
    p.add_argument("--fused", type=int, default=4,
                   help="the timer's fused window (beside unfused)")
    args = p.parse_args(argv)
    if args.kernel == "generate" and (args.split is not None
                                      or args.weights_l2 or args.timer):
        p.error("--split, --weights-l2 and --timer are the cluster "
                "kernel's (--kernel cluster)")
    if args.timer and (args.only or args.split is not None
                       or args.weights_l2):
        p.error("--timer runs the decode's layouts: no --only, --split or "
                "--weights-l2")
    if args.fused < 1:
        p.error("--fused must be >= 1")
    dtypes = tuple(DTYPES) if args.dtype == "both" else (args.dtype,)
    batches = [int(b) for b in args.batches.split(",")]
    if not torch.cuda.is_available():
        print("kprobe: CUDA is not available", file=sys.stderr)
        return 1
    head = {"preset": args.preset, "T": args.steps,
            "device": torch.cuda.get_device_name(0)}
    if args.timer:
        for row in timer_sweep(args.preset, dtypes, max(batches),
                               args.steps, args.fused):
            print(json.dumps({**head, **row}), flush=True)
        return 0
    for dt in dtypes:
        for row in sweep(args.preset, dt, batches, args.steps, args.chunk,
                         [a for a in args.only.split(",") if a], args.reps,
                         kernel=args.kernel, split=args.split,
                         weights_l2=args.weights_l2):
            print(json.dumps({**head, "dtype": dt, "chunk": args.chunk,
                              "kernel": args.kernel, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
