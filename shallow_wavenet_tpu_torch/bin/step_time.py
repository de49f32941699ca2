"""Time the AR kernel's sample step on one card, for a paired comparison of
two trees of the port.

    python3 shallow_wavenet_tpu_torch/bin/step_time.py [--root DIR] \\
        [--preset shallow_laplace_single] [--batch 8] [--steps 2048] \\
        [--cluster N]

Imports shallow_wavenet_tpu_torch from --root (default: the tree that holds
this file), so one copy of this script times any tree whose `ops.ar_kernel`
has `generate(pp, cfg, c_up, noise=...)`. It builds that tree's kernel,
draws random weights (seed 0, head2 std 0.05, as chip_smoke.py does) and
random normalized frames, and prints one JSON line: the root, the card's
name and power limit, and the kernel's mean time per call and per step by
CUDA events over --reps calls after one warm-up call. The layout timed is
the fp32 one-SM-per-row kernel with resident rings, which every tree of the
port has; --cluster N times the cluster kernel of N SMs per row instead,
placed as the decode places it, and --cluster auto the decode's fp32
layout (`ar_kernel.choose_layout`; both on trees that have it). Compare
two trees on one card in one session, in the order parent, change,
change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    p.add_argument("--preset", default="shallow_laplace_single")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=2048)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cluster", default="0",
                   help="cluster size N of the cluster kernel, 'auto' for "
                        "the decode's choice, 0 for the one-SM-per-row "
                        "kernel")
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    from shallow_wavenet_tpu_torch.config import get_config
    from shallow_wavenet_tpu_torch.models.wavenet import (
        WaveNet, extract_plain_params, init_params_tree, params_from_flax,
    )
    from shallow_wavenet_tpu_torch.ops import ar_kernel

    if not torch.cuda.is_available():
        print("step_time: CUDA is not available", file=sys.stderr)
        return 1
    mc = get_config(args.preset).model
    tree = init_params_tree(mc, args.seed)
    rng = np.random.default_rng(args.seed + 1000)
    tree["head2"]["kernel"] = (0.05 * rng.standard_normal(
        tree["head2"]["kernel"].shape)).astype(np.float32)
    model = params_from_flax(WaveNet(mc), tree).cuda()
    pp = extract_plain_params(model)
    B, T = args.batch, args.steps
    hop = int(np.prod(mc.upsample_factors))
    cond = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
        (B, -(-T // hop), mc.aux_channels)).astype(np.float32)).cuda()
    with torch.no_grad():
        c_up = model.upsample_cond(cond)[:, :T].contiguous()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    noise = ar_kernel.uniform_noise((B, T), g)
    kw = {}
    if args.cluster != "0":
        kw["layout"] = ar_kernel.choose_layout(
            mc, "float32", cluster=True if args.cluster == "auto"
            else int(args.cluster))
    cluster = kw["layout"].cluster if kw else 0

    def call():
        return ar_kernel.generate(pp, mc, c_up, noise=noise, **kw)

    call()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.reps):
        call()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / args.reps
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": str(root), "card": smi, "preset": args.preset,
                      "cluster": cluster, "B": B, "T": T, "reps": args.reps,
                      "ms": ms,
                      "us_per_step": 1e3 * ms / T}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
