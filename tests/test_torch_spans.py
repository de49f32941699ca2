"""The port's own spans (`utils.observability.span`) on the CPU, at
tests/test_model.py::tiny_cfg's widths, without JAX:

- with the profiler off, a `decode_batch` and a `StreamPool.step` record
  nothing;
- under `torch.profiler`, `decode_batch` records its call's spans, each
  under its parent and with the call's id, and the pool's step its
  members' spans: one `swt.stream.upsample` per member, no `swt.ar.pack`
  (the pool packs the kernel's weights once, when it is made);
- `maybe_profile`'s chrome trace holds each `swt.*` name as a
  `user_annotation`, and the self times of its `spans.json` add up to the
  roots' totals;
- `decode_batch`'s samples are the same to the bit with spans on and off;
- a span keeps the decision taken at its entry, takes its parent's id,
  and is a root on a thread of its own.
"""

import json
import threading

import numpy as np
import pytest
import torch

from shallow_wavenet_tpu_torch.bin import decode
from shallow_wavenet_tpu_torch.config import Config, DataConfig, ModelConfig
from shallow_wavenet_tpu_torch.data.dataset import Utterance
from shallow_wavenet_tpu_torch.models.streaming import StreamPool
from shallow_wavenet_tpu_torch.models.wavenet import (
    WaveNet, extract_plain_params,
)
from shallow_wavenet_tpu_torch.utils.observability import (
    clear_spans, maybe_profile, recorded_spans, span,
)

DECODE = ("swt.decode.batch", "swt.decode.pad", "swt.decode.upsample",
          "swt.decode.params", "swt.decode.noise", "swt.decode.copy_back",
          "swt.ar.generate", "swt.ar.pack", "swt.ar.launch")
POOL = ("swt.pool.step", "swt.stream.next_block", "swt.stream.upsample",
        "swt.stream.prepare", "swt.pool.launch", "swt.pool.copy_back",
        "swt.pool.finish", "swt.ar.generate", "swt.ar.launch")
BLOCK = 32


@pytest.fixture(scope="module")
def setup():
    """tiny_cfg's widths in the port's config, random weights (head2
    included, so the samples are not constant)."""
    mc = ModelConfig(n_stacks=1, stack_size=4, residual_channels=16,
                     gate_channels=32, skip_channels=24, aux_channels=8,
                     head="laplace", upsample_factors=(2, 5),
                     cond_channels=12, compute_dtype="float32")
    cfg = Config(model=mc, data=DataConfig(hop_length=10))
    torch.manual_seed(0)
    model = WaveNet(mc)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.3 * torch.randn_like(p))
    return cfg, model


@pytest.fixture(autouse=True)
def empty_buffer():
    clear_spans()
    yield
    clear_spans()


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _utts(cfg, frames=(9, 6, 12), seed=1):
    r = np.random.default_rng(seed)
    return [Utterance(np.zeros(0, np.float32), r.standard_normal(
        (n, cfg.model.aux_channels)).astype(np.float32)) for n in frames]


def _decode(cfg, model, noise=None):
    utts = _utts(cfg)
    if noise is None:
        T = max(u.feats.shape[0] for u in utts) * cfg.data.hop_length
        noise = torch.rand((len(utts), T),
                           generator=torch.Generator().manual_seed(5))
        noise = noise * (1 - 2e-7) + 1e-7
    return decode.decode_batch(model, cfg, utts, noise=noise,
                               device="cpu"), noise


def _pool(cfg, model):
    return StreamPool(extract_plain_params(model), model, cfg.model,
                      hop_length=cfg.data.hop_length, slots=4,
                      block_frames=BLOCK, chunk=64, device="cpu")


def _open_two(cfg, pool):
    """Two streams with a whole block each (and its halo): one step
    launches both."""
    r = np.random.default_rng(2)
    sids = []
    for seed in (3, 4):
        sid = pool.open(seed=seed)
        pool.push(sid, r.standard_normal(
            (BLOCK + pool.halo, cfg.model.aux_channels)).astype(np.float32))
        sids.append(sid)
    return sids


def _by_index(spans):
    return {s["index"]: s for s in spans}


def _names(spans):
    return {s["name"] for s in spans}


def test_spans_off_record_nothing(setup):
    cfg, model = setup
    assert span("swt.x") is span("swt.y", id=3)     # one shared no-op
    _decode(cfg, model)
    pool = _pool(cfg, model)
    _open_two(cfg, pool)
    assert pool.step()
    assert recorded_spans() == []


def test_decode_batch_spans(setup):
    cfg, model = setup
    with profiled():
        _decode(cfg, model)
        _decode(cfg, model)
    spans = recorded_spans()
    at = _by_index(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["swt.decode.batch"] * 2
    assert roots[1]["id"] == roots[0]["id"] + 1
    for root in roots:
        mine = [s for s in spans if s["id"] == root["id"]]
        assert sorted(s["name"] for s in mine) == sorted(DECODE)
        parent = {s["name"]: at[s["parent"]]["name"] for s in mine
                  if s["parent"] is not None}
        assert parent == {
            "swt.decode.pad": "swt.decode.batch",
            "swt.decode.upsample": "swt.decode.batch",
            "swt.decode.params": "swt.decode.batch",
            "swt.decode.noise": "swt.decode.batch",
            "swt.decode.copy_back": "swt.decode.batch",
            "swt.ar.generate": "swt.decode.batch",
            "swt.ar.pack": "swt.ar.generate",
            "swt.ar.launch": "swt.ar.generate"}
        for s in mine:
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= root["end_ns"]


def test_pool_step_spans(setup):
    cfg, model = setup
    pool = _pool(cfg, model)
    sids = _open_two(cfg, pool)
    with profiled():
        out = pool.step()
    assert sorted(out) == sids
    spans = recorded_spans()
    at = _by_index(spans)
    assert _names(spans) == set(POOL)
    (step,) = [s for s in spans if s["parent"] is None]
    assert (step["name"], step["id"]) == ("swt.pool.step", 1)

    def under(name):
        return [s for s in spans if s["name"] == name]

    for name in ("swt.stream.next_block", "swt.stream.prepare"):
        assert sorted(s["id"] for s in under(name)) == sids
        assert {at[s["parent"]]["name"] for s in under(name)} \
            == {"swt.pool.step"}
    # one upsampler call for every member's window, under the step
    (up,) = under("swt.stream.upsample")
    assert up["parent"] == step["index"]
    (launch,) = under("swt.pool.launch")
    assert launch["id"] == 0 and launch["parent"] == step["index"]
    for name in ("swt.pool.copy_back", "swt.pool.finish"):
        (s,) = under(name)
        assert s["parent"] == step["index"] and s["id"] == step["id"]
    (gen,) = under("swt.ar.generate")
    assert gen["parent"] == launch["index"] and gen["id"] == 0

    # the next step warm-starts both streams: phase 1, step 2
    pool.push(sids[0], np.zeros((BLOCK, cfg.model.aux_channels),
                                np.float32))
    pool.push(sids[1], np.zeros((BLOCK, cfg.model.aux_channels),
                                np.float32))
    clear_spans()
    with profiled():
        assert sorted(pool.step()) == sids
    spans = recorded_spans()
    (step,) = [s for s in spans if s["parent"] is None]
    assert step["id"] == 2
    assert [s["id"] for s in spans if s["name"] == "swt.pool.launch"] == [1]
    assert "swt.ar.pack" not in _names(spans)


def test_maybe_profile_trace_and_summary(setup, tmp_path):
    cfg, model = setup
    pool = _pool(cfg, model)
    _open_two(cfg, pool)
    with span("swt.outside"):
        pass
    with maybe_profile(tmp_path / "prof"):
        _decode(cfg, model)
        pool.step()
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert set(DECODE) | set(POOL) <= annotated
    summary = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert set(summary) == set(DECODE) | set(POOL)
    for name, e in summary.items():
        assert e["count"] >= 1
        assert 0 <= e["self_ms"] <= e["total_ms"] + 1e-9, name
    assert summary["swt.stream.upsample"]["count"] == 1
    # every span's time is its own or its parent's: the self times add
    # up to the roots' totals
    roots = summary["swt.decode.batch"]["total_ms"] \
        + summary["swt.pool.step"]["total_ms"]
    assert sum(e["self_ms"] for e in summary.values()) \
        == pytest.approx(roots, rel=1e-9)


def test_decode_samples_same_with_spans_on_and_off(setup):
    cfg, model = setup
    off, noise = _decode(cfg, model)
    with profiled():
        on, _ = _decode(cfg, model, noise)
    assert recorded_spans()
    assert len(on) == len(off) == 3
    for a, b in zip(on, off):
        assert a.tobytes() == b.tobytes()


def test_a_span_keeps_its_decision_its_parents_id_and_its_thread():
    prof = profiled()
    prof.start()
    outer = span("swt.t.outer", id="call")
    outer.__enter__()
    with span("swt.t.inner"):
        pass

    def on_a_thread():
        with span("swt.t.thread"):
            pass

    t = threading.Thread(target=on_a_thread)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    prof.stop()
    outer.__exit__(None, None, None)          # entered on: recorded
    with span("swt.t.after"):                  # entered off: not
        pass
    got = {s["name"]: s for s in recorded_spans()}
    assert set(got) == {"swt.t.outer", "swt.t.inner", "swt.t.thread"}
    assert got["swt.t.inner"]["parent"] == got["swt.t.outer"]["index"]
    assert got["swt.t.inner"]["id"] == "call"
    assert got["swt.t.thread"]["parent"] is None
    assert got["swt.t.thread"]["id"] is None
