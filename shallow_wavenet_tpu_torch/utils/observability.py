"""Observability — the torch twin of
`shallow_wavenet_tpu/utils/observability.py`: TensorBoard scalars, profiler
traces of the hot train/decode regions, and a fail-fast NaN mode.

- `MetricsWriter`: TensorBoard scalars through tensorboardX, a no-op (one
  warning) where tensorboardX is missing.
- `maybe_profile(logdir)`: a `torch.profiler` trace of the enclosed region
  (CPU, and CUDA where there is a card), one `*.pt.trace.json` per process
  under `logdir` (`tensorboard_trace_handler`); open it in Perfetto or
  chrome://tracing, or with tensorboard's profile plugin.
- `enable_debug_mode()` / `disable_debug_mode()`: the counterpart of
  `jax_debug_nans`. Autograd's anomaly mode checks every backward op, and
  `Trainer.step` checks each update's loss, gradient norm and parameters
  for finite values (one host sync per update, only in this mode), raising
  `FloatingPointError` that names the step. Both are process-wide; a
  caller that turns the mode on in a long-lived process turns it off after.
"""

from __future__ import annotations

import contextlib
import logging
import numbers
from pathlib import Path

import torch

log = logging.getLogger(__name__)

_DEBUG_NANS = False


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


@contextlib.contextmanager
def maybe_profile(logdir: str | Path | None):
    """torch.profiler trace of the enclosed region when logdir is given:
    CPU activity, and the card's kernels where CUDA is available, written
    as `<logdir>/<host>_<pid>.<time>.pt.trace.json` when the region ends."""
    if not logdir:
        yield
        return
    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))):
        yield
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
