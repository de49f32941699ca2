"""Live streams: an open loop of callers on the port's `StreamPool`.

Mix parameters: `streams`, the callers N; `slots`, the pool's slots (above
N, so a caller never waits for a slot while its last stream drains);
`block_frames` and `chunk`, the pool's block geometry; `utt_seconds` and
`pause_seconds`, the sequences of every caller's utterance lengths and
pauses, each caller starting them at its own offset (`Caller`);
`warm_frames`, the set-up streams' frame counts; `trace_at_s` and
`trace_s`, where and how long the traced run profiles; `drain_s`, how long
after the window the blocks due in it may take to come out.

Caller c starts at c / N of a block after the window opens. It opens a
stream, pushes `block_frames` frames every block on the wall-clock
schedule (push k due at its start + k blocks), ends the stream after its
last push, pauses and opens the next. One thread pushes every frame that
is due, calls `step()` and stamps each emitted block. A block is due when
the last frame it needs (its upsampling halo included) was due, or at the
stream's end; its latency runs from then to the return of the `step()`
that emitted it. Blocks due in the window are counted; after the window no
stream opens, and the run goes on until each of them has come out.

The check: every stream's emitted samples teacher-forced through the
reference, each stream alone, with its conditioning upsampled block by
block from haloed windows of its frames (`reference.upsample_blocks`) and
its own uniforms, the widest gap against the cell's limit (the sample gap
for the Laplace head, the CDF gap for the softmax head, `reference.judge`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import inputs, profiling, reference
from port_bench.generators.offline import load_model
from port_bench.harness import Record


class Caller:
    """Caller c of N: its utterance lengths and pauses are the mix's sets,
    each rotated by c / N of its length, so that every seed offers the same
    schedule (the seed draws the frames and the streams' uniforms) and the
    callers' long and short utterances do not line up."""

    def __init__(self, c, n, seed, mix, sr, hop, start):
        self.c, self.seed = c, seed
        self.lengths = _rotated(mix["utt_seconds"], c, n)
        self.pauses = _rotated(mix["pause_seconds"], c, n)
        self.frames_per_s = sr / hop
        self.k = 0                  # utterances opened
        self.next_open = start      # scheduled start of the next utterance
        self.sid = None
        self.frames = None
        self.pushed = 0             # pushes done of the current utterance
        self.t_open = None

    def utterance(self, aux):
        k = self.k
        n = int(round(self.lengths[k % len(self.lengths)]
                      * self.frames_per_s))
        r = inputs.rng(self.seed, "streams", self.c, k)
        frames = r.standard_normal((n, aux)).astype(np.float32)
        stream_seed = int(r.integers(0, 2 ** 31 - 1))
        return frames, stream_seed


def _rotated(values, c: int, n: int) -> np.ndarray:
    v = np.asarray(values, float)
    return np.roll(v, -(c * len(v)) // n)


def block_due(t_open: float, F: int, bf: int, H: int, block_s: float):
    """When each block of a stream of F frames is due: push k (frames
    [k bf, (k + 1) bf)) is due at t_open + k blocks, and block j needs the
    frames up to (j + 1) bf + H, or, where that passes the utterance's
    end, its last push (the stream ends with it)."""
    return [t_open + (min((j + 1) * bf + H, F) - 1) // bf * block_s
            for j in range(-(-F // bf))]


def run(ctx) -> Record:
    from shallow_wavenet_tpu_torch.models.streaming import StreamPool
    from shallow_wavenet_tpu_torch.models.wavenet import extract_plain_params
    from shallow_wavenet_tpu_torch.ops import ar_kernel

    cfg, mix, dev = ctx.program_config(), ctx.mix, ctx.device
    mc, hop, sr = ctx.model_dict(), cfg.data.hop_length, cfg.data.sample_rate
    bf = mix["block_frames"]
    block_s = bf * hop / sr
    w = inputs.weights(mc, ctx.seed, dev)
    model = load_model(cfg, w, dev)
    ctx.mark("weights")
    pool = StreamPool(extract_plain_params(model), model, cfg.model, hop,
                      slots=mix["slots"], block_frames=bf,
                      chunk=mix["chunk"], device=dev)
    H = pool.halo
    ctx.mark("pool")

    # set-up: streams of every tail length at once, so both launch phases
    # and the tail blocks' upsampling run before the window
    r = inputs.rng(ctx.seed, "warm")
    for i, n in enumerate(mix["warm_frames"]):
        sid = pool.open(seed=i)
        pool.push(sid, r.standard_normal((n, mc["aux_channels"]))
                  .astype(np.float32))
        pool.end(sid)
        if not pool.free_slots or i == len(mix["warm_frames"]) - 1:
            while pool.active:
                pool.step()

    tracer = profiling.Tracer(dev) if ctx.trace else None
    if tracer:
        tracer.warm()
        tracer.install(ar_kernel)
    N = mix["streams"]
    t0 = ctx.window_opens()
    t_end = t0 + ctx.seconds
    callers = [Caller(c, N, ctx.seed, mix, sr, hop, t0 + c * block_s / N)
               for c in range(N)]
    streams = {}       # sid -> dict(frames, seed, due, emitted, pieces)
    lateness = []
    steps = []
    # the traced stretch: trace_s seconds from the first step after
    # trace_at_s, so that it holds whole steps
    t_trace = [t0 + mix["trace_at_s"], None]
    tracing = False
    # launches in the traced stretch and in the window outside it, and the
    # traced stretch's span (the untraced idle share reads them)
    launched = {"traced": 0, "untraced": 0}
    traced_span = [None, None]

    def pending_due():
        return any(len(s["emitted"]) < len(s["due"])
                   and s["due"][len(s["emitted"])] <= t_end
                   for s in streams.values())

    def open_stream(cl):
        frames, sseed = cl.utterance(mc["aux_channels"])
        cl.sid, cl.frames, cl.pushed = pool.open(sseed), frames, 0
        cl.t_open = cl.next_open
        due = block_due(cl.t_open, len(frames), bf, H, block_s)
        streams[cl.sid] = {"frames": frames, "seed": sseed, "due": due,
                           "emitted": [], "pieces": []}
        cl.k += 1

    def push_due(cl, now):
        n_push = -(-len(cl.frames) // bf)
        while cl.pushed < n_push and (cl.t_open + cl.pushed * block_s
                                      <= now):
            lo = cl.pushed * bf
            pool.push(cl.sid, cl.frames[lo:lo + bf])
            lateness.append(now - (cl.t_open + cl.pushed * block_s))
            cl.pushed += 1
        if cl.pushed == n_push:
            pool.end(cl.sid)
            cl.next_open = (cl.t_open + (n_push - 1) * block_s
                            + cl.pauses[(cl.k - 1) % len(cl.pauses)])
            cl.sid = None

    try:
        while True:
            now = time.perf_counter()
            if tracer and t_trace[1] is None and now >= t_trace[0]:
                tracer.start()
                tracing = True
                traced_span[0] = time.perf_counter()
                t_trace[1] = traced_span[0] + mix["trace_s"]
            elif tracing and now >= t_trace[1]:
                tracer.stop()
                tracing = False
                traced_span[1] = time.perf_counter()
            if now >= t_end:
                if not pending_due():
                    break
                if now - t_end > mix["drain_s"]:
                    raise RuntimeError(
                        "blocks due in the window did not come out within "
                        f"{mix['drain_s']} s of its end")
            for cl in callers:
                if cl.sid is None and cl.next_open <= now \
                        and cl.next_open < t_end:
                    open_stream(cl)
                if cl.sid is not None:
                    push_due(cl, now)
            d0 = pool.dispatches
            a = time.perf_counter()
            with profiling.span("pb.pool.step", tracing):
                out = pool.step()
            b = time.perf_counter()
            if tracing:
                launched["traced"] += pool.dispatches - d0
            elif a < t_end:
                launched["untraced"] += pool.dispatches - d0
            if out:
                steps.append({"t0": a, "t1": b,
                              "launches": pool.dispatches - d0,
                              "samples": sum(len(v) for v in out.values()),
                              "traced": tracing, "in_window": a < t_end})
                for sid, samples in out.items():
                    streams[sid]["emitted"].append(b)
                    streams[sid]["pieces"].append(samples)
                continue
            # nothing was ready: sleep until the next push is due
            nxt = [cl.t_open + cl.pushed * block_s for cl in callers
                   if cl.sid is not None]
            nxt += [cl.next_open for cl in callers
                    if cl.sid is None and cl.next_open < t_end]
            wait = (min(nxt) if nxt else now + 0.001) - time.perf_counter()
            if wait > 0:
                time.sleep(min(wait, 0.005))
        if tracing:
            tracer.stop()
            traced_span[1] = time.perf_counter()
    finally:
        if tracer:
            tracer.uninstall()
    window_steps = [s for s in steps if s["in_window"]]
    overlap = (max(0.0, min(traced_span[1], t_end) - max(traced_span[0], t0))
               if traced_span[1] is not None else 0.0)
    lat, due_at, n_blocks = [], [], 0
    for s in streams.values():
        for j, t_out in enumerate(s["emitted"]):
            if s["due"][j] <= t_end:
                lat.append(t_out - s["due"][j])
                due_at.append(s["due"][j] - t0)
    order = np.argsort(due_at)
    third = max(len(order) // 3, 1)
    early = float(np.median(np.asarray(lat)[order[:third]]))
    late_third = float(np.median(np.asarray(lat)[order[-third:]]))
    tr = tracer.result(["pb.pool.step"]) if tracer else None
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del pool, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: every stream's samples, its whole utterance upsampled at
    # once, teacher-forced through the reference with its own uniforms
    check, gaps_of = reference.judge(mc)
    gaps, control, fp8, block = [], [], [], bf * hop
    for s in streams.values():
        if not s["pieces"]:
            continue
        wav = np.concatenate(s["pieces"])
        n = len(wav)
        F = len(s["frames"])
        frames = torch.from_numpy(s["frames"]).to(dev)
        c_up = reference.upsample_blocks(w, mc, frames, bf)[:n]
        u = inputs.stream_uniforms(s["seed"], -(-F // bf), block)[:n]
        args = (w, mc, c_up, torch.from_numpy(u).to(dev),
                torch.from_numpy(wav).to(dev))
        gaps.append(float(gaps_of(*args).max()))
        if ctx.readings:
            control.append(float(gaps_of(*args, control=True).max()))
            fp8.append(float(gaps_of(*args, c_low=reference.upsample_blocks(
                w, mc, frames, bf, reference.fp8)[:n]).max()))
        n_blocks += len(s["pieces"])
    limit = ctx.limits[check]
    readings = {f"control.{check}": max(control, default=None),
                f"control_fp8.{check}": max(fp8, default=None)}
    late = np.asarray(lateness) * 1e3
    step_ms = 1e3 * float(np.median([s["t1"] - s["t0"]
                                     for s in window_steps]))
    ctx.log(f"{len(streams)} streams, {len(lat)} blocks due in the window, "
            f"{len(window_steps)} steps; block latency median "
            f"{float(np.median(lat)) * 1e3:.3f} ms (first third of the "
            f"window {early * 1e3:.3f}, last third {late_third * 1e3:.3f}); "
            f"step median {step_ms:.3f} ms; pushes late by median "
            f"{float(np.median(late)):.3f} ms, "
            f"p95 {float(np.percentile(late, 95)):.3f} ms, max "
            f"{float(late.max()):.3f} ms; {check} {max(gaps)!r}")
    facts = {"block_latency_s": lat, "steps": window_steps,
             "samples": sum(s["samples"] for s in window_steps),
             "frames": sum(s["samples"] for s in window_steps) // hop,
             "launches": sum(s["launches"] for s in window_steps),
             "model": mc,
             "idle_units": (launched["traced"], launched["untraced"],
                            ctx.seconds - overlap),
             "readings": readings}
    return Record(kind="live", window_s=ctx.seconds, facts=facts,
                  checks=[(check, max(gaps), limit)],
                  attempted=n_blocks,
                  failed=sum(g > limit for g in gaps),
                  memory_peak_bytes=peak, trace=tr)
