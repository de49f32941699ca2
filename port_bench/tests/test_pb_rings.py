"""The readers of the wide cluster kernel's rings: the `swt.ar.rings` span
per traced call, and the share of ring bytes that live in a global ring
from the program's `ar_kernel.ring_bytes` counter. Both read nothing where
the program made no global ring or keeps no such span or counter."""

from __future__ import annotations

import collections
import types

import pytest

from port_bench import harness
from port_bench.tests.test_pb_spans import Spans, decode_calls


def decode_calls_wide() -> list:
    """Two traced calls, each with a global ring made inside its AR kernel
    call (the wide form): 2 and 3 ms."""
    s = Spans()
    for t0, rings in ((1000, 2), (2000, 3)):
        b = s.add("swt.decode.batch", t0, t0 + 30, id=t0)
        g = s.add("swt.ar.generate", t0 + 8, t0 + 20, b)
        la = s.add("swt.ar.launch", t0 + 9, t0 + 19, g)
        s.add("swt.ar.rings", t0 + 10, t0 + 10 + rings, la)
    return s.out


@pytest.fixture(scope="module")
def readers():
    return harness.readers(harness.ROOT)


@pytest.mark.parametrize("n, want", [(2, (2 + 3) / 2), (1, 3.0)])
def test_rings_span_arithmetic(readers, n, want):
    r = readers["decode.rings_ms_per_batch"]
    assert (r.KIND, r.SOURCE) == ("per_layer", "program_span")
    assert r.value(decode_calls_wide(), n) == pytest.approx(want, rel=1e-12)


def test_rings_read_nothing_without_a_root(readers):
    r = readers["decode.rings_ms_per_batch"]
    assert r.value([], 2) is None
    assert r.value(decode_calls_wide(), 0) is None


def test_rings_read_nothing_where_no_call_made_a_global_ring(readers):
    """A program that makes no global ring (every form but the wide one,
    or a parent that has no such span) leaves the metric out."""
    assert readers["decode.rings_ms_per_batch"].value(decode_calls(), 2) \
        is None


def test_global_ring_share_from_the_programs_counter(readers, monkeypatch):
    """100 x global / (shared + global) of `ar_kernel.ring_bytes`; nothing
    where every ring stayed in shared memory, the program keeps no such
    counter, or the run was not traced."""
    from shallow_wavenet_tpu_torch.ops import ar_kernel
    r = readers["ar.global_ring_pct"]
    assert (r.KIND, r.SOURCE) == ("per_layer", "program_counter")
    rec = types.SimpleNamespace(kind="offline", trace=object())
    monkeypatch.setattr(ar_kernel, "ring_bytes", collections.Counter(
        shared=93 * 4))
    assert r.read(rec, None) is None
    monkeypatch.setattr(ar_kernel, "ring_bytes", collections.Counter(
        {"shared": 93 * 4, "global": 2976 * 4}))
    assert r.read(rec, None) == pytest.approx(100 * 2976 / 3069,
                                              rel=1e-12)
    assert r.read(types.SimpleNamespace(kind="offline", trace=None),
                  None) is None
    monkeypatch.delattr(ar_kernel, "ring_bytes")
    assert r.read(rec, None) is None
