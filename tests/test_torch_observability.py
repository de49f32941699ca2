"""utils/observability.py on the CPU: the port's TensorBoard scalars, its
profiler traces and its fail-fast NaN mode, at tests/test_train.py's tiny
training size.

- `Trainer.fit` writes the records of `metrics.jsonl` as TensorBoard
  scalars under `<workdir>/tb` (read back with tensorboard's
  EventAccumulator: the same tags, steps and values, to float32), and
  `MetricsWriter.scalars` admits numpy scalars and skips the rest;
- without tensorboardX the writer is a no-op that warns once;
- `maybe_profile` writes one trace that parses as JSON, and nothing for
  None;
- debug mode raises FloatingPointError at the update whose batch holds a
  NaN, for K = 1 and K = 4, where the default mode runs on, and at one
  whose backward alone makes a NaN; a clean run's records are the same to
  the bit with it on;
- `bin.train --profile --debug-nans`, K = 2: the trace holds the
  trainer's spans and the data path's consumer wait as
  `user_annotation`s, and `spans.json` holds every trainer and data path
  span, the prefetcher thread's `to_device` included.
Anomaly mode is process-wide: a fixture turns debug mode off after every
test and checks that it is off.
"""

import json
import logging
import sys

import numpy as np
import pytest
import torch

from shallow_wavenet_tpu_torch.bin import train
from shallow_wavenet_tpu_torch.data.prefetch import GroupSampler
from shallow_wavenet_tpu_torch.training import Trainer
from shallow_wavenet_tpu_torch.utils import observability
from shallow_wavenet_tpu_torch.utils.observability import (
    MetricsWriter, disable_debug_mode, enable_debug_mode, maybe_profile,
)

from tests.test_torch_train_loop import (
    _corpus, fit, make_sampler, records, tiny_train_cfg,
)


@pytest.fixture(autouse=True)
def debug_off():
    """One intra-op thread; debug mode off after each test, and checked."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        disable_debug_mode()
        torch.set_num_threads(n)
    assert not torch.is_anomaly_enabled()
    assert not observability.debug_mode()


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_fit_writes_the_records_as_scalars(tmp_path):
    cfg = tiny_train_cfg(log_every=2, checkpoint_every=3)
    fit(cfg, tmp_path, 6)
    recs = records(tmp_path)
    assert [r["step"] for r in recs] == [2, 4, 6]
    got = _scalars(tmp_path / "tb")
    keys = {k for r in recs for k in r}      # "step" too, as in JAX
    assert set(got) == keys
    for k in keys:
        want = [(r["step"], np.float32(r[k])) for r in recs if k in r]
        assert [(s, np.float32(v)) for s, v in got[k]] == want, k


def test_scalars_admit_numpy_and_skip_the_rest(tmp_path):
    w = MetricsWriter(tmp_path)
    assert w.live
    w.scalars(3, {"np32": np.float32(1.5), "np64": np.float64(-2.25),
                  "npint": np.int64(7), "py": 0.5, "text": "skip",
                  "none": None, "arr": np.ones(2)})
    w.close()
    got = _scalars(tmp_path)
    assert got == {"np32": [(3, 1.5)], "np64": [(3, -2.25)],
                   "npint": [(3, 7.0)], "py": [(3, 0.5)]}


def test_writer_without_tensorboardx_is_a_noop(tmp_path, monkeypatch,
                                                caplog):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with caplog.at_level(logging.WARNING):
        w = MetricsWriter(tmp_path / "tb")
        w.scalars(1, {"loss": 1.0})
        w.scalars(2, {"loss": 0.5})
        w.close()
    assert not w.live
    warned = [r for r in caplog.records
              if "tensorboard writer unavailable" in r.getMessage()]
    assert len(warned) == 1
    assert not (tmp_path / "tb").exists()
    # and fit runs on without it
    fit(tiny_train_cfg(log_every=2), tmp_path / "run", 2)
    assert [r["step"] for r in records(tmp_path / "run")] == [2]
    assert not (tmp_path / "run/tb").exists()


def test_maybe_profile_writes_a_trace(tmp_path):
    with maybe_profile(tmp_path / "prof"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with maybe_profile(None):
        torch.ones(2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["prof"]


def _nan_group(cfg, k, at):
    """k stacked batches of the tiny sampler, a NaN in batch `at`'s x."""
    group = next(GroupSampler(make_sampler(cfg), k))
    group["x"][at, 0, 5] = np.nan
    return group


@pytest.mark.parametrize("k", [1, 4])
def test_debug_mode_raises_at_the_nan_update(k):
    cfg = tiny_train_cfg(steps_per_call=k)
    tr = Trainer(cfg, "cpu")
    state = tr.init_state()
    at = 0 if k == 1 else 2
    group = _nan_group(cfg, k, at)

    def run():
        if k == 1:
            return tr.step(state, {kk: v[0] for kk, v in group.items()})
        return tr.multi_step(state, group)

    # the default mode runs on and returns a NaN loss
    _, m = run()
    assert not np.isfinite(np.asarray(m["loss"]).reshape(-1)[at])
    enable_debug_mode()
    assert torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match=f"loss at update {at + 1}$"):
        run()
    disable_debug_mode()
    assert not torch.is_anomaly_enabled()


def test_debug_mode_names_a_nan_made_in_the_backward(monkeypatch):
    """A finite loss whose backward makes a NaN (sqrt's gradient at 0 times
    a zero upstream gradient): anomaly mode's report becomes a
    FloatingPointError naming the update."""
    cfg = tiny_train_cfg()
    tr = Trainer(cfg, "cpu")
    state = tr.init_state()
    batch = next(make_sampler(cfg))
    real = tr._loss_fn

    def loss_fn(params, mb, gen=None):
        return real(params, mb, gen) + 0.0 * torch.sqrt(params[0] * 0.0)

    monkeypatch.setattr(tr, "_loss_fn", loss_fn)
    _, m = tr.step(state, batch)             # off: a NaN gradient, no raise
    assert np.isfinite(float(m["loss"])) and not np.isfinite(
        float(m["grad_norm"]))
    enable_debug_mode()
    with pytest.raises(FloatingPointError,
                       match="gradient at update 1: .*nan values"):
        tr.step(state, batch)


def test_debug_mode_keeps_a_clean_run_to_the_bit(tmp_path):
    cfg = tiny_train_cfg(log_every=1, steps_per_call=2)
    fit(cfg, tmp_path / "off", 6)
    enable_debug_mode()
    fit(cfg, tmp_path / "on", 6)
    off, on = records(tmp_path / "off"), records(tmp_path / "on")
    assert [r["step"] for r in on] == [2, 4, 6]
    for a, b in zip(off, on):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])


def test_train_cli_profile_and_debug_nans(tmp_path):
    cfg = tiny_train_cfg(checkpoint_every=4, log_every=2, steps_per_call=2)
    (tmp_path / "config.json").write_text(cfg.to_json())
    feats = _corpus(tmp_path, cfg)
    args = ["--config", str(tmp_path / "config.json"), "--feats-dir",
            str(feats), "--stats", str(tmp_path / "stats.h5"),
            "--train-scp", str(tmp_path / "corpus/train.scp"),
            "--steps", "4", "--device", "cpu"]
    train.main(args + ["--workdir", str(tmp_path / "a"), "--profile",
                       "--debug-nans"])
    assert not torch.is_anomaly_enabled()      # the CLI turned it off
    traces = list((tmp_path / "a/profile").glob("*.pt.trace.json"))
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert len(traces) == 1 and events
    main_thread = {"swt.train.multi_step", "swt.train.step",
                   "swt.train.forward", "swt.train.backward",
                   "swt.train.apply", "swt.data.next"}
    assert main_thread <= {e["name"] for e in events
                           if e.get("cat") == "user_annotation"}
    spans = json.loads((tmp_path / "a/profile/spans.json").read_text())
    assert main_thread | {"swt.data.put"} <= set(spans)
    assert spans["swt.train.step"]["count"] == 4
    assert spans["swt.train.multi_step"]["count"] == 2
    train.main(args + ["--workdir", str(tmp_path / "b")])
    a, b = records(tmp_path / "a"), records(tmp_path / "b")
    assert [r["step"] for r in a] == [2, 4]
    assert [r["loss"] for r in a] == [r["loss"] for r in b]
    assert not (tmp_path / "b/profile").exists()
    assert _scalars(tmp_path / "a/tb")["loss"][-1][0] == 4
