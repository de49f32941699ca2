"""The readers of the program's spans, on a fixed list of span records:
each metric's arithmetic, the last n roots only (an earlier run's spans in
the same process are not read), and nothing read where there is no root."""

from __future__ import annotations

import pytest

from port_bench import harness

MS = 1_000_000          # ns


class Spans:
    """Span records as `observability.recorded_spans()` gives them."""

    def __init__(self):
        self.out = []

    def add(self, name, start_ms, end_ms, parent=None, id=None):
        rec = {"index": len(self.out), "name": name, "id": id,
               "parent": None if parent is None else parent["index"],
               "start_ns": int(start_ms * MS), "end_ns": int(end_ms * MS)}
        self.out.append(rec)
        return rec


def decode_calls() -> list:
    """An earlier run's call, then two traced calls: 30 ms with 10 of
    copy-back, 2 of params and 3 of packing; 50 ms with 20, 4 and 5."""
    s = Spans()
    s.add("swt.decode.batch", 0, 999, id=0)
    for t0, (dur, back, params, pack) in ((1000, (30, 10, 2, 3)),
                                          (2000, (50, 20, 4, 5))):
        b = s.add("swt.decode.batch", t0, t0 + dur, id=t0)
        s.add("swt.decode.params", t0 + 1, t0 + 1 + params, b)
        g = s.add("swt.ar.generate", t0 + 8, t0 + dur - back - 1, b)
        s.add("swt.ar.pack", t0 + 9, t0 + 9 + pack, g)
        s.add("swt.ar.launch", t0 + 15, t0 + 16, g)
        s.add("swt.decode.copy_back", t0 + dur - back, t0 + dur, b)
    return s.out


def pool_steps() -> list:
    """Three traced steps: one with no block ready (no launch), one with
    two members' upsampling (3 and 5 ms) in a 40 ms step with 12 ms of
    copy-back, one with a single member's (4 ms) in 20 ms with 6."""
    s = Spans()
    st = s.add("swt.pool.step", 0, 1, id=1)
    s.add("swt.stream.next_block", 0.1, 0.2, st, id=0)
    for t0, dur, back, ups in ((10, 40, 12, (3, 5)), (60, 20, 6, (4,))):
        st = s.add("swt.pool.step", t0, t0 + dur, id=t0)
        t = t0
        for sid, up in enumerate(ups):
            nb = s.add("swt.stream.next_block", t, t + up + 1, st, id=sid)
            s.add("swt.stream.upsample", t + 0.5, t + 0.5 + up, nb)
            t += up + 1
        la = s.add("swt.pool.launch", t, t + 1, st, id=1)
        s.add("swt.ar.generate", t, t + 1, la)
        s.add("swt.pool.copy_back", t + 1, t + 1 + back, st)
    return s.out


@pytest.fixture(scope="module")
def readers():
    return harness.readers(harness.ROOT)


@pytest.mark.parametrize("metric, spans, n, want", [
    ("decode.self_ms_per_batch", decode_calls, 2, (20 + 30) / 2),
    ("decode.pack_ms_per_batch", decode_calls, 2, (5 + 9) / 2),
    ("decode.self_ms_per_batch", decode_calls, 3, (999 + 20 + 30) / 3),
    ("pool.self_ms_per_step", pool_steps, 3, (28 + 14) / 2),
    ("pool.upsample_ms_per_step", pool_steps, 3, (8 + 4) / 2),
    ("pool.upsamples_per_step", pool_steps, 3, (2 + 1) / 2),
    ("pool.upsamples_per_step", pool_steps, 1, 1.0),
])
def test_span_readers_arithmetic(readers, metric, spans, n, want):
    r = readers[metric]
    assert (r.KIND, r.SOURCE) == ("per_layer", "program_span")
    assert r.value(spans(), n) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", [
    "decode.self_ms_per_batch", "decode.pack_ms_per_batch",
    "pool.self_ms_per_step", "pool.upsample_ms_per_step",
    "pool.upsamples_per_step"])
def test_span_readers_read_nothing_without_a_root(readers, metric):
    r = readers[metric]
    assert r.value([], 2) is None
    own, other = ((decode_calls(), pool_steps()) if metric.startswith(
        "decode") else (pool_steps(), decode_calls()))
    assert r.value(other, 2) is None
    assert r.value(own, 0) is None
