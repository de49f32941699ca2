"""Check and time the ring-window copy probe on the card — the counterpart of
the TPU probe `tools/dma_probe.py`.

    python3 -m shallow_wavenet_tpu_torch.bin.dma_probe [--reps 20]

Every copy variant (`ops.ring_probe.VARIANTS`: the serial tma and cp_async,
the pipelined tma_pipe and cp_async_pipe) is checked at every shape of
`ops.ring_probe.SHAPES` (the TPU probe's, 132 rows over 64 chunks, each
batch at the other chunk count, and the TPU probe's batch over 64 slots,
where no chunk reloads a slot written in the launch) and `ORDER_SHAPES`
(ordering only): its output must equal the plain version and the closed
form (chunk i holds i // per + 1) exactly. Then, at every shape of
`SHAPES`, the variants are timed in turns (each in order, then in the
reverse order), each time at the launch alone: a ring and an output made
once, and after a warm-up --reps repetitions of `ring.zero_()` plus one
launch, by CUDA events, all queued behind a device spin so that the device
sets the pace. The zeroing stays in because the bound counts the ring's
bytes. Beside it, `ms_call` is the wrapper-call time: back-to-back calls of
`ring_probe`, which also allocates and zeroes the ring and allocates the
output on the host's clock. And `fill_ms`: PyTorch's `ring.zero_()` plus
`out.fill_(1.0)`, timed as the launch, the bound's bytes written at the
rate the card gives a plain fill.

One JSON line per (shape, variant): the check, `ms` (the mean of the two
turns) and `ms_turns`, `ms_call`, us per chunk, `bound_ms` (the output and
the zeroed ring, each written once, over the H100's 3.35 TB/s) and the
share of it, `gb_s` (the windows in, out and back over the time), `l2_gb_s`
(the copies in and back alone: they move between the ring in L2 and shared
memory; the data sheet gives no L2 rate to hold it against) and `out_gb_s`
(the output alone), and the pipelined variants' split. Exits 1 when a check
fails or CUDA is missing.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from shallow_wavenet_tpu_torch.ops import ring_probe

PEAK_BYTES = 3.35e12             # H100 SXM HBM3 (NVIDIA data sheet)
REPS = 20
CALL_REPS = 5                    # the wrapper-call timing
SHAPES = {**ring_probe.SHAPES, **ring_probe.ORDER_SHAPES}
# about 5 ms of device spin at the H100's clocks: more than the host takes
# to queue REPS launches of the probe and its zeroing
QUEUE_CYCLES = 10_000_000


def _cuda(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("dma_probe times the CUDA kernel; it needs CUDA")
    return dev


def check(kw: dict, variant: str, device=None) -> dict:
    """One wrapper call of `variant` at shape `kw`, held against the plain
    version and the closed form."""
    dev = _cuda(device)
    out = ring_probe.ring_probe(**kw, variant=variant, device=dev)
    plain = ring_probe.ring_probe_plain(**kw, device=dev)
    return {"exact": bool(torch.equal(out, plain) and torch.equal(
                out, ring_probe.expected(**kw, device=dev))),
            "max_abs_err": float((out - plain).abs().max())}


def _event_ms(fn, reps: int, queue_first: bool = False) -> float:
    """Mean ms of fn() over `reps` calls by CUDA events. queue_first: the
    device first spins (torch.cuda._sleep) long enough for the host to
    queue every call, so that the device, not the host, sets the pace."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queue_first:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(kw: dict, variant: str, reps: int = REPS,
              device=None) -> float:
    """Mean ms of `ring.zero_()` plus one launch of `variant` at shape `kw`,
    on a ring and an output made once, over `reps` after a warm-up."""
    dev = _cuda(device)
    ring = torch.empty((kw["batch"], kw["per"] * kw["chunk"],
                        kw["channels"]), device=dev)
    out = torch.empty((kw["n_chunks"] * kw["chunk"], kw["batch"],
                       kw["channels"]), device=dev)

    def rep():
        ring.zero_()
        ring_probe.ring_probe_into(ring, out, kw["chunk"], kw["per"],
                                   variant)

    for _ in range(3):
        rep()
    return _event_ms(rep, reps, queue_first=True)


def fill_ms(kw: dict, reps: int = REPS, device=None) -> float:
    """Mean ms of `ring.zero_()` plus `out.fill_(1.0)` at shape `kw`, timed
    as `launch_ms`: PyTorch's fill kernels writing the bound's bytes, what
    the card gives for them (not the probe's function)."""
    dev = _cuda(device)
    ring = torch.empty((kw["batch"], kw["per"] * kw["chunk"],
                        kw["channels"]), device=dev)
    out = torch.empty((kw["n_chunks"] * kw["chunk"], kw["batch"],
                       kw["channels"]), device=dev)

    def rep():
        ring.zero_()
        out.fill_(1.0)

    for _ in range(3):
        rep()
    return _event_ms(rep, reps, queue_first=True)


def call_ms(kw: dict, variant: str, reps: int = CALL_REPS,
            device=None) -> float:
    """The wrapper-call time: mean ms of back-to-back calls of `ring_probe`
    (each allocates and zeroes its ring and allocates its output)."""
    dev = _cuda(device)
    ring_probe.ring_probe(**kw, variant=variant, device=dev)
    return _event_ms(lambda: ring_probe.ring_probe(**kw, variant=variant,
                                                   device=dev), reps)


def _row(shape: str, variant: str, checked: dict, ms: list, ms_call: list,
         device, fill: float = None) -> dict:
    kw = SHAPES[shape]
    row = {"shape": shape, "variant": variant, **kw, **checked,
           "timed": bool(ms)}
    if variant in ring_probe.PIPE_COPY:
        row["split"] = ring_probe.split(
            kw["chunk"], kw["batch"], kw["channels"], kw["per"],
            *ring_probe.limits(device))
    if ms:
        t = sum(ms) / len(ms)
        bound = 1e3 * ring_probe.bound_bytes(**kw) / PEAK_BYTES
        row.update(
            ms=t, ms_turns=ms, ms_call=sum(ms_call) / len(ms_call),
            us_per_chunk=1e3 * t / kw["n_chunks"], bound_ms=bound,
            bound_share=bound / t, fill_ms=fill,
            gb_s=ring_probe.moved_bytes(**kw) / (t * 1e-3) / 1e9,
            l2_gb_s=ring_probe.l2_bytes(**kw) / (t * 1e-3) / 1e9,
            out_gb_s=4.0 * kw["n_chunks"] * kw["chunk"] * kw["batch"]
            * kw["channels"] / (t * 1e-3) / 1e9)
    return row


def run(shape: str, variant: str, reps: int = REPS, device=None) -> dict:
    """The check of one (shape, variant) and, at a shape of SHAPES, its
    launch-alone and wrapper-call times."""
    dev = _cuda(device)
    kw = SHAPES[shape]
    timed = shape in ring_probe.SHAPES
    return _row(shape, variant, check(kw, variant, dev),
                [launch_ms(kw, variant, reps, dev)] if timed else [],
                [call_ms(kw, variant, device=dev)] if timed else [], dev,
                fill_ms(kw, reps, dev) if timed else None)


def sweep(variants=ring_probe.VARIANTS, reps: int = REPS,
          device=None) -> list[dict]:
    """Every variant checked at every shape of SHAPES and ORDER_SHAPES,
    then timed at every shape of SHAPES in turns (each variant in order,
    then in the reverse order); one row per (shape, variant)."""
    dev = _cuda(device)
    rows = []
    for shape, kw in SHAPES.items():
        checks = {v: check(kw, v, dev) for v in variants}
        ms = {v: [] for v in variants}
        ms_call = {v: [] for v in variants}
        fill = None
        if shape in ring_probe.SHAPES:
            for v in list(variants) + list(reversed(variants)):
                ms[v].append(launch_ms(kw, v, reps, dev))
                ms_call[v].append(call_ms(kw, v, device=dev))
            fill = fill_ms(kw, reps, dev)
        rows += [_row(shape, v, checks[v], ms[v], ms_call[v], dev, fill)
                 for v in variants]
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("dma_probe: CUDA is not available", file=sys.stderr)
        return 1
    rows = sweep(reps=args.reps)
    for row in rows:
        print(json.dumps({"device": torch.cuda.get_device_name(0), **row}),
              flush=True)
    return 0 if all(r["exact"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
