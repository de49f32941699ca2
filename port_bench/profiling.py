"""The traced window: torch.profiler over a short steady stretch of a run,
and the reduction of its trace to what the per-layer metrics read.

Spans are recorded from the benchmark's own files, around its calls into
the program (`span`), and around `ops.ar_kernel.generate`, installed on the
module attribute for the traced run only (`Tracer.install`): the AR
kernel's device time is that of the device operations launched inside that
call, whatever kernel implements it. The trace is exported to one file
under TMPDIR, read back and deleted.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

GENERATE = "pb.ar_kernel.generate"
WINDOW = "pb.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str, on: bool):
    """A profiler range named `name` when `on`, else nothing."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@dataclass
class Trace:
    """What a traced window holds, in seconds."""
    window_s: float
    busy_s: float
    kernels: int
    device_ops: list            # [[name, seconds], ...] by total, <= 10
    idle_gaps: list             # [[host span, seconds], ...], <= 10
    spans: dict = field(default_factory=dict)
    # {span name: [{"wall_s", "device_s", "generate_s"}, ...]} in order;
    # device_s: the device time of the operations launched inside the
    # span, generate_s: of those launched inside its AR kernel calls
    generate_calls: list = field(default_factory=list)
    # [{"device_s", "shape": (B, T), "dtype", "lengths"}] per generate
    # call; lengths: the rows' steps, None where the call passed none


class Tracer:
    """Profiles one stretch of a run: `warm()` in set-up, `install()` wraps
    the AR kernel's entry, `start()`/`stop()` bound the window, `result()`
    reads it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.shapes = []
        self._prof = None
        self._window = None
        self._restore = None

    def install(self, ar_kernel_module) -> None:
        orig = ar_kernel_module.generate
        shapes = self.shapes

        def generate(pp, cfg, c_up, *args, **kw):
            with torch.profiler.record_function(GENERATE):
                lengths = kw.get("lengths")
                shapes.append((tuple(c_up.shape[:2]),
                               kw.get("dtype", "float32"),
                               None if lengths is None
                               else [int(n) for n in lengths]))
                return orig(pp, cfg, c_up, *args, **kw)

        ar_kernel_module.generate = generate
        self._restore = (ar_kernel_module, orig)

    def uninstall(self) -> None:
        if self._restore is not None:
            mod, orig = self._restore
            mod.generate = orig
            self._restore = None

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once around one device op, so that
        its first start (CUPTI's set-up, seconds) falls in the run's
        set-up and not in the traced stretch."""
        with self._profile():
            torch.ones(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._prof = self._profile()
        self._prof.start()
        self.shapes.clear()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self._prof.stop()

    def result(self, span_names=()) -> Trace:
        fd, path = tempfile.mkstemp(prefix="pb_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        return reduce(events, tuple(span_names), list(self.shapes))


def reduce(events, span_names, shapes) -> Trace:
    """The Trace of a chrome-trace event list (times in microseconds)."""
    ranges, launches, ops = {}, {}, []
    for e in events:
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat == "user_annotation" and e.get("name", "").startswith("pb."):
            ranges.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = float(e["ts"])
        elif cat in DEVICE_CATS:
            ops.append((e.get("name", cat), float(e["ts"]),
                        float(e.get("dur", 0)), args.get("correlation"),
                        cat))
    if WINDOW not in ranges:
        raise RuntimeError("the traced window's range is missing from the "
                           "trace")
    w0, w1 = ranges[WINDOW][0]
    inside = [(n, max(ts, w0), min(ts + d, w1), corr, cat)
              for n, ts, d, corr, cat in ops if ts < w1 and ts + d > w0]
    busy = _union((a, b) for _, a, b, _, _ in inside)
    by_name: dict = {}
    for n, a, b, _, _ in inside:
        by_name[n[:160]] = by_name.get(n[:160], 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps on the device, labelled by the innermost benchmark span
    # open on the host at the gap's middle
    labelled = [(name, a, b) for name, rs in ranges.items()
                if name != WINDOW for a, b in rs]
    gaps: dict = {}
    t = w0
    for _, a, b, _, _ in sorted(inside, key=lambda o: o[1]):
        if a > t:
            mid = (a + t) / 2
            holder = [(b2 - a2, name) for name, a2, b2 in labelled
                      if a2 <= mid <= b2]
            label = min(holder)[1] if holder else "between spans"
            gaps[label] = gaps.get(label, 0.0) + (a - t)
        t = max(t, b)
    if w1 > t:
        gaps["between spans"] = gaps.get("between spans", 0.0) + (w1 - t)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

    def device_in(rs):
        """Per range, the device seconds of the ops launched inside it."""
        out = []
        for a, b in rs:
            tot = sum(d_b - d_a for _, d_a, d_b, corr, _ in inside
                      if corr in launches and a <= launches[corr] <= b)
            out.append(tot / 1e6)
        return out

    gen_rs = ranges.get(GENERATE, [])
    gen_dev = device_in(gen_rs)
    spans = {}
    for name in span_names:
        rs = ranges.get(name, [])
        spans[name] = [{"wall_s": (b - a) / 1e6, "device_s": d,
                        "generate_s": sum(g for (ga, gb), g in
                                          zip(gen_rs, gen_dev)
                                          if a <= ga and gb <= b)}
                       for (a, b), d in zip(rs, device_in(rs))]
    gen = [{"device_s": d, "shape": s[0], "dtype": s[1], "lengths": s[2]}
           for d, s in zip(gen_dev, shapes)]
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                 kernels=sum(1 for o in inside if o[4] == "kernel"),
                 device_ops=[[n, s / 1e6] for n, s in top],
                 idle_gaps=[[n, s / 1e6] for n, s in idle],
                 spans=spans, generate_calls=gen)
