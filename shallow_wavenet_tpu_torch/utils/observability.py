"""Observability — the torch twin of
`shallow_wavenet_tpu/utils/observability.py`: TensorBoard scalars, profiler
traces of the hot train/decode regions, and a fail-fast NaN mode.

- `MetricsWriter`: TensorBoard scalars through tensorboardX, a no-op (one
  warning) where tensorboardX is missing.
- `maybe_profile(logdir)`: a `torch.profiler` trace of the enclosed region
  (CPU, and CUDA where there is a card), one `*.pt.trace.json` per process
  under `logdir` (`tensorboard_trace_handler`); open it in Perfetto or
  chrome://tracing, or with tensorboard's profile plugin. Beside it,
  `spans.json`: per span name, its count, total and self milliseconds.
- `span(name, id)`: a named span of the program's own work (`swt.*`).
  With the profiler off it is one check and a shared no-op. With it on
  (`maybe_profile`, or any `torch.profiler` in the process) it is a
  `record_function` range in the same trace as the device's operations
  (on the thread that started the profiler), and on exit it appends one
  record to a bounded in-memory buffer:
  `index`, `name`, `id`, `parent` (the enclosing span's `index` on the
  same thread, or None), `start_ns`, `end_ns` (`time.perf_counter_ns`).
  A span given no id takes its parent's, so every span of one call or
  one stream shares one. `recorded_spans()` returns a copy of the
  buffer, `clear_spans()` empties it.
- `enable_debug_mode()` / `disable_debug_mode()`: the counterpart of
  `jax_debug_nans`. Autograd's anomaly mode checks every backward op, and
  `Trainer.step` checks each update's loss, gradient norm and parameters
  for finite values (one host sync per update, only in this mode), raising
  `FloatingPointError` that names the step. Both are process-wide; a
  caller that turns the mode on in a long-lived process turns it off after.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import numbers
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

log = logging.getLogger(__name__)

_DEBUG_NANS = False

# the span records of the profiled stretches, oldest dropped first:
# (index, name, id, parent, start_ns, end_ns)
_SPANS: collections.deque = collections.deque(maxlen=1 << 16)
_SPAN_INDEX = itertools.count()
_OPEN = threading.local()           # .stack: the thread's open spans
_OFF = contextlib.nullcontext()


class MetricsWriter:
    """TensorBoard scalar writer (tensorboardX), no-op if unavailable."""

    def __init__(self, logdir: str | Path, enabled: bool = True):
        self._w = None
        if not enabled:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError as e:
            log.warning("tensorboard writer unavailable: %s", e)
            return
        self._w = SummaryWriter(str(logdir))

    @property
    def live(self) -> bool:
        """Whether scalars are written (tensorboardX importable)."""
        return self._w is not None

    def scalars(self, step: int, values: dict) -> None:
        if self._w is None:
            return
        for k, v in values.items():
            # numbers.Real also admits numpy scalars (np.float32 etc.),
            # which a plain (int, float) isinstance silently drops
            if isinstance(v, numbers.Real):
                self._w.add_scalar(k, float(v), step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


class _Span:
    """A span the profiler was on for at entry: recorded at exit, whether
    or not the profiler is still on."""
    __slots__ = ("name", "id", "index", "parent", "start", "_range")

    def __init__(self, name: str, id):
        self.name, self.id = name, id

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        up = stack[-1] if stack else None
        self.parent = None if up is None else up.index
        if self.id is None and up is not None:
            self.id = up.id
        self.index = next(_SPAN_INDEX)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _OPEN.stack.pop()
        self._range.__exit__(*exc)
        _SPANS.append((self.index, self.name, self.id, self.parent,
                       self.start, end))
        return False


def span(name: str, id=None):
    """A context manager around one piece of the program's work: a
    profiler range and a span record while the profiler is on (decided at
    entry), else a shared no-op. id: the call, step or stream it belongs
    to; None takes the enclosing span's. The check is the process's
    profiler flag, not the calling thread's: a worker thread (the data
    path's prefetcher) records its spans too."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, id)


def recorded_spans() -> list[dict]:
    """A copy of the span buffer, in the order the spans ended."""
    keys = ("index", "name", "id", "parent", "start_ns", "end_ns")
    return [dict(zip(keys, r)) for r in list(_SPANS)]


def clear_spans() -> None:
    """Empty the span buffer."""
    _SPANS.clear()


def _span_summary(spans) -> dict:
    """{name: {"count", "total_ms", "self_ms"}} of span records; a span's
    self time is its duration less its child spans' (children run within
    their parent, one after another, on the parent's thread)."""
    child_ns: dict = {}
    for s in spans:
        if s["parent"] is not None:
            child_ns[s["parent"]] = (child_ns.get(s["parent"], 0)
                                     + s["end_ns"] - s["start_ns"])
    out: dict = {}
    for s in spans:
        d = s["end_ns"] - s["start_ns"]
        e = out.setdefault(s["name"], {"count": 0, "total_ms": 0.0,
                                       "self_ms": 0.0})
        e["count"] += 1
        e["total_ms"] += d / 1e6
        e["self_ms"] += (d - child_ns.get(s["index"], 0)) / 1e6
    return out


@contextlib.contextmanager
def maybe_profile(logdir: str | Path | None):
    """torch.profiler trace of the enclosed region when logdir is given:
    CPU activity, and the card's kernels where CUDA is available, written
    as `<logdir>/<host>_<pid>.<time>.pt.trace.json` when the region ends,
    with the region's spans summed by name in `<logdir>/spans.json`
    (`_span_summary`); the span buffer is emptied when the region starts."""
    if not logdir:
        yield
        return
    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    clear_spans()
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))):
        yield
    (Path(logdir) / "spans.json").write_text(
        json.dumps(_span_summary(recorded_spans()), indent=1))
    log.info("profiler trace written to %s", logdir)


def enable_debug_mode() -> None:
    """NaN debugging: fail fast at the first non-finite update (anomaly
    mode in the backward, finiteness checks in Trainer.step)."""
    global _DEBUG_NANS
    _DEBUG_NANS = True
    torch.autograd.set_detect_anomaly(True)
    log.info("debug mode: anomaly detection and finiteness checks on")


def disable_debug_mode() -> None:
    """Undo `enable_debug_mode`."""
    global _DEBUG_NANS
    _DEBUG_NANS = False
    torch.autograd.set_detect_anomaly(False)


def debug_mode() -> bool:
    """Whether `enable_debug_mode` is in force."""
    return _DEBUG_NANS
