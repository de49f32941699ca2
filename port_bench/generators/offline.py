"""Offline decode: a closed loop of the decode CLI's `decode_batch` calls.

Mix parameters: `batch` utterances per call; `frames`, the set of frame
counts every batch holds (rows shuffled from the seed, so every seed does
the same work); `kernel_dtype` and `fused`, the CLI's options
(`decode_layout`); `warm_frames`, the frames per row of the set-up call
that builds, loads and launches the kernel; `trace_calls`, the calls the
traced run profiles after the window.

Each batch's frames (standard normal, as normalized features) and
uniforms are drawn from the seed and the batch's index. Batches run back
to back until `--seconds` have passed; the batch in flight is finished and
counted. The check: every utterance of every call, teacher-forced through
the reference, its widest gap against the cell's limit: the sample gap
(`max_sample_gap`, `reference.sample_gaps`) for the Laplace head, the CDF
gap (`max_cdf_gap`, `reference.cdf_gaps`) for the softmax head.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import inputs, profiling, reference
from port_bench.harness import Record


def load_model(cfg, w, device):
    """The port's WaveNet on `device` with the weights `w` (flax names)."""
    from shallow_wavenet_tpu_torch.models.wavenet import WaveNet
    model = WaveNet(cfg.model).to(device)
    model.load_state_dict({k.replace("/", "."): v for k, v in w.items()},
                          strict=True)
    return model


class Batches:
    """Batch i's utterances and uniforms, from the seed and i."""

    def __init__(self, seed, mix, mc, hop, device, purpose="traffic"):
        self.seed, self.aux, self.hop = seed, mc["aux_channels"], hop
        self.purpose = purpose
        self.device = device
        self.frames = np.asarray(mix["frames"], dtype=int)
        if len(self.frames) != mix["batch"]:
            raise ValueError("the mix's frame set must have one entry per "
                             "row of the batch")

    def get(self, i: int):
        from shallow_wavenet_tpu_torch.data.dataset import Utterance
        r = inputs.rng(self.seed, self.purpose, i)
        lens = r.permutation(self.frames)
        utts = [Utterance(np.zeros(0, np.float32), r.standard_normal(
            (int(f), self.aux)).astype(np.float32)) for f in lens]
        noise = inputs.uniforms(
            (len(lens), int(lens.max()) * self.hop),
            inputs.generator(self.seed, self.purpose, self.device, i,
                             1))
        return utts, noise


def run(ctx) -> Record:
    from shallow_wavenet_tpu_torch.bin import decode
    from shallow_wavenet_tpu_torch.ops import ar_kernel

    cfg, mix, dev = ctx.program_config(), ctx.mix, ctx.device
    mc, hop, sr = ctx.model_dict(), cfg.data.hop_length, cfg.data.sample_rate
    w = inputs.weights(mc, ctx.seed, dev)
    model = load_model(cfg, w, dev)
    ctx.mark("weights")
    layout = decode.decode_layout(cfg.model, mix["kernel_dtype"], dev,
                                  mix["fused"])
    waves = decode.warn_waves(cfg.model, layout, mix["batch"], dev)
    ctx.mark("layout")
    src = Batches(ctx.seed, mix, mc, hop, dev)

    # set-up: one call at the cell's batch with short rows builds, loads
    # and launches the kernel; the upsampler runs once at the longest row
    warm = Batches(ctx.seed, dict(mix, frames=[mix["warm_frames"]]
                                  * mix["batch"]), mc, hop, dev, "warm")
    utts, noise = warm.get(0)
    decode.decode_batch(model, cfg, utts, noise=noise, layout=layout,
                        device=dev)
    with torch.no_grad():
        model.upsample_cond(torch.zeros(
            (mix["batch"], int(src.frames.max()), mc["aux_channels"]),
            device=dev))
    ctx.log(f"layout {layout}, {waves} wave(s) per batch")
    tracer = profiling.Tracer(dev) if ctx.trace else None
    if tracer:
        tracer.warm()

    calls, kept = [], []

    def one(i, traced=False):
        utts, noise = src.get(i)
        t0 = time.perf_counter()
        with profiling.span("pb.decode_batch", traced):
            wavs = decode.decode_batch(model, cfg, utts, noise=noise,
                                       layout=layout, device=dev)
        t1 = time.perf_counter()
        calls.append({"t0": t0, "t1": t1, "samples": sum(map(len, wavs)),
                      "frames": sum(u.feats.shape[0] for u in utts),
                      "traced": traced})
        kept.append((utts, noise, wavs))

    ctx.window_opens()
    i = 0
    while True:
        one(i)
        i += 1
        if calls[-1]["t1"] - calls[0]["t0"] >= ctx.seconds:
            break
    window = [c for c in calls if not c["traced"]]
    window_s = window[-1]["t1"] - window[0]["t0"]

    tr = None
    if tracer:
        tracer.install(ar_kernel)
        try:
            tracer.start()
            for _ in range(mix["trace_calls"]):
                one(i, traced=True)
                i += 1
            tracer.stop()
        finally:
            tracer.uninstall()
        tr = tracer.result(["pb.decode_batch"])
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check, once the window has closed: every utterance teacher-forced
    # through the reference
    check, gaps_of = reference.judge(mc)
    gaps, control, fp8 = [], [], []
    for utts, noise, wavs in kept:
        from_frames = torch.from_numpy(np.stack([
            np.pad(u.feats, ((0, noise.shape[1] // hop - u.feats.shape[0]),
                             (0, 0))) for u in utts])).to(dev)
        c_up = reference.upsample(w, mc, from_frames)
        if ctx.readings:
            c_fp8 = reference.upsample(w, mc, from_frames, reference.fp8)
        for r, wav in enumerate(wavs):
            n = len(wav)
            args = (w, mc, c_up[r, :n], noise[r, :n],
                    torch.from_numpy(wav).to(dev))
            gaps.append(float(gaps_of(*args).max()))
            if ctx.readings:
                control.append(float(gaps_of(*args, control=True).max()))
                fp8.append(float(gaps_of(*args, c_low=c_fp8[r, :n]).max()))
    limit = ctx.limits[check]
    readings = {f"control.{check}": max(control, default=None),
                f"control_fp8.{check}": max(fp8, default=None)}
    facts = {
        "audio_s": sum(c["samples"] for c in window) / sr,
        "samples": sum(c["samples"] for c in window),
        "frames": sum(c["frames"] for c in window),
        "model": mc,
        "readings": readings,
    }
    call_ms = 1e3 * float(np.median([c["t1"] - c["t0"] for c in window]))
    ctx.log(f"{len(window)} calls in {window_s:.4f} s; per call median "
            f"{call_ms:.3f} ms; {facts['samples']} samples; {check} "
            f"{max(gaps)!r} over {len(gaps)} utterances")
    return Record(kind="offline", window_s=window_s, facts=facts,
                  checks=[(check, max(gaps), limit)],
                  attempted=len(gaps),
                  failed=sum(g > limit for g in gaps),
                  memory_peak_bytes=peak, trace=tr)
