"""Check and time the ring-window copy probe on the card — the counterpart of
the TPU probe `tools/dma_probe.py`.

    python3 -m shallow_wavenet_tpu_torch.bin.dma_probe [--reps 5]

For each shape (`ops.ring_probe.SHAPES`: the TPU probe's, one block per SM
over 64 chunks, and each batch at the other chunk count) and copy variant,
one JSON line: whether the kernel's output equals the plain version and the
closed form (chunk i holds i // per + 1) exactly, and the mean time of one
call by CUDA events over --reps calls after the checked one, per call and
per chunk. Two rates: `gb_s`, the bytes the copies move (three windows per
chunk and row: in, out, back), most of them between L2 and shared memory
(the ring, 8.6 MB at B = 132, stays in the 50 MB L2); and `out_gb_s`, the
output alone, which must reach device memory, with its share of the H100's
3.35 TB/s. A call's time includes the wrapper's zeroing of the ring. Exits
1 when a check fails or CUDA is missing.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from shallow_wavenet_tpu_torch.ops import ring_probe

PEAK_BYTES = 3.35e12             # H100 SXM HBM3 (NVIDIA data sheet)


def run(shape: str, variant: str, reps: int = 5, device=None) -> dict:
    """The check and the time of one (shape, variant)."""
    kw = ring_probe.SHAPES[shape]
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("dma_probe times the CUDA kernel; it needs CUDA")
    out = ring_probe.ring_probe(**kw, variant=variant, device=dev)
    plain = ring_probe.ring_probe_plain(**kw, device=dev)
    exact = (torch.equal(out, plain)
             and torch.equal(out, ring_probe.expected(**kw, device=dev)))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        ring_probe.ring_probe(**kw, variant=variant, device=dev)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    out_rate = 4.0 * out.numel() / (ms * 1e-3)
    return {"shape": shape, "variant": variant, **kw, "exact": exact,
            "max_abs_err": float((out - plain).abs().max()), "ms": ms,
            "us_per_chunk": 1e3 * ms / kw["n_chunks"],
            "gb_s": ring_probe.moved_bytes(**kw) / (ms * 1e-3) / 1e9,
            "out_gb_s": out_rate / 1e9,
            "out_share_of_peak": out_rate / PEAK_BYTES}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("dma_probe: CUDA is not available", file=sys.stderr)
        return 1
    ok = True
    for shape in ring_probe.SHAPES:
        for variant in ring_probe.VARIANTS:
            row = run(shape, variant, args.reps)
            ok &= row["exact"]
            print(json.dumps({"device": torch.cuda.get_device_name(0),
                              **row}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
