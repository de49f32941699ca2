"""The host side of the ring-window copy probe's pipelined variants
(shallow_wavenet_tpu_torch.ops.ring_probe, tma_pipe and cp_async_pipe): the
split of each row's window over blocks, the buffers `ring_probe_into`
takes, and the launch-alone timer's refusal without CUDA. The kernels
themselves run only on the card (chip_smoke.py phase 13)."""

import pytest
import torch

from shallow_wavenet_tpu_torch.bin import dma_probe
from shallow_wavenet_tpu_torch.ops import ring_probe

H100 = dict(sms=132, smem_per_block=232448)


def _covered(kw, sp):
    """Every (row, t) of the window held by exactly one block."""
    seen = {}
    for row, t0, nt in ring_probe.pieces(kw["chunk"], kw["batch"], **sp):
        assert nt >= 1
        for t in range(t0, t0 + nt):
            seen[row, t] = seen.get((row, t), 0) + 1
    return seen == {(b, t): 1 for b in range(kw["batch"])
                    for t in range(kw["chunk"])}


@pytest.mark.parametrize("kw", [
    *ring_probe.SHAPES.values(), *ring_probe.ORDER_SHAPES.values(),
    dict(chunk=64, batch=1, channels=128, per=2),
    dict(chunk=7, batch=132, channels=4, per=1),
    dict(chunk=50, batch=33, channels=8, per=4),
    dict(chunk=100, batch=131, channels=128, per=9),
    dict(chunk=3, batch=2, channels=4, per=5),
], ids=lambda kw: "c{chunk}b{batch}r{channels}p{per}".format(**kw))
@pytest.mark.parametrize("limits", [H100, dict(sms=16, smem_per_block=8192)],
                         ids=["h100", "small"])
def test_split_covers_every_row_t_once(kw, limits):
    sp = ring_probe.split(kw["chunk"], kw["batch"], kw["channels"],
                          kw["per"], **limits)
    assert _covered(kw, sp)
    rows = sp["rows_per_block"]
    assert 1 <= rows <= kw["chunk"]
    assert sp["blocks_per_row"] == -(-kw["chunk"] // rows)
    assert 1 <= sp["stages"] <= min(kw["per"] + 1, ring_probe.MAX_STAGES)
    assert sp["smem_bytes"] == sp["stages"] * rows * 4 * kw["channels"]
    assert sp["smem_bytes"] + ring_probe.STATIC_SMEM <= \
        limits["smem_per_block"]


def test_split_at_the_probe_shapes():
    """On an H100: 528 blocks at 132 rows (4 pieces of 16 rows, 3 stages),
    one t row per block at 8 rows, and the ragged ordering shape."""
    def sp(kw):
        return ring_probe.split(kw["chunk"], kw["batch"], kw["channels"],
                                kw["per"], **H100)
    assert sp(ring_probe.SHAPES["rate"]) == {
        "blocks_per_row": 4, "rows_per_block": 16, "stages": 3,
        "smem_bytes": 3 * 16 * 512}
    assert sp(ring_probe.SHAPES["jax"])["rows_per_block"] == 1
    ragged = ring_probe.ORDER_SHAPES["per3_ragged"]
    assert ragged["chunk"] % sp(ragged)["rows_per_block"] != 0
    assert sp(ring_probe.ORDER_SHAPES["per1"])["stages"] == 2


def test_split_refuses_a_row_past_shared_memory():
    with pytest.raises(ValueError, match="one t row"):
        ring_probe.split(64, 8, 4096, 2, sms=132, smem_per_block=16384)


@pytest.mark.parametrize("shape", ring_probe.ORDER_SHAPES)
def test_order_shapes_plain_is_the_closed_form(shape):
    kw = ring_probe.ORDER_SHAPES[shape]
    got = ring_probe.ring_probe_plain(**kw, device="cpu")
    torch.testing.assert_close(got, ring_probe.expected(**kw), rtol=0,
                               atol=0)


@pytest.mark.parametrize("variant", ["tma_pipe", "cp_async_pipe"])
def test_into_runs_the_plain_version_on_cpu(variant):
    """On CPU buffers `ring_probe_into` runs the plain loop in place: the
    output is the closed form, the ring holds each slot's last window, and
    nothing is launched."""
    kw = dict(chunk=3, batch=2, channels=4, per=2, n_chunks=5)
    ring = torch.zeros((2, 6, 4))
    out = torch.full((15, 2, 4), -1.0)
    ring_probe.ring_probe_into(ring, out, 3, 2, variant)
    torch.testing.assert_close(out, ring_probe.expected(**kw), rtol=0,
                               atol=0)
    # slot 0 was last written by chunk 4 (value 3), slot 1 by chunk 3 (2)
    assert ring[:, :3].eq(3.0).all() and ring[:, 3:].eq(2.0).all()
    assert not ring_probe.launches


@pytest.mark.parametrize("ring, out, chunk, per, match", [
    (torch.zeros(2, 6), torch.empty(15, 2, 4), 3, 2, "buffers"),
    (torch.zeros(2, 6, 4), torch.empty(15, 2, 4), 3, 0, "per"),
    (torch.zeros(2, 5, 4), torch.empty(15, 2, 4), 3, 2, "do not match"),
    (torch.zeros(2, 6, 4), torch.empty(14, 2, 4), 3, 2, "do not match"),
    (torch.zeros(2, 6, 4), torch.empty(15, 3, 4), 3, 2, "do not match"),
    (torch.zeros(2, 6, 6), torch.empty(15, 2, 6), 3, 2, "multiple of 4"),
    (torch.zeros(2, 6, 4, dtype=torch.float64), torch.empty(15, 2, 4), 3, 2,
     "fp32"),
    (torch.zeros(2, 4, 6).transpose(1, 2), torch.empty(15, 2, 4), 3, 2,
     "contiguous"),
], ids=["dims", "per", "ring", "out_rows", "out_batch", "channels", "dtype",
        "contiguous"])
def test_into_checks(ring, out, chunk, per, match):
    with pytest.raises(ValueError, match=match):
        ring_probe.ring_probe_into(ring, out, chunk, per, "tma_pipe")
    assert not ring_probe.launches


def test_into_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        ring_probe.ring_probe_into(torch.zeros(2, 6, 4),
                                   torch.empty(15, 2, 4), 3, 2, "tma_ring")


def test_launch_timer_raises_without_cuda(monkeypatch):
    kw = ring_probe.SHAPES["jax"]
    for device in ("cpu", None):
        if device is None:
            monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for fn in (dma_probe.launch_ms, dma_probe.call_ms, dma_probe.check):
            with pytest.raises(RuntimeError, match="needs CUDA"):
                fn(kw, "tma_pipe", device=device)
        with pytest.raises(RuntimeError, match="needs CUDA"):
            dma_probe.sweep(device=device)
        with pytest.raises(RuntimeError, match="needs CUDA"):
            dma_probe.run("per1", "cp_async_pipe", device=device)
    assert not ring_probe.launches


def test_bound_and_l2_bytes():
    """The rate shape's bound: the output and the zeroed ring over 3.35
    TB/s, 0.0852 ms; the copies in and back cross L2, twice the output."""
    kw = ring_probe.SHAPES["rate"]
    bound = 1e3 * ring_probe.bound_bytes(**kw) / dma_probe.PEAK_BYTES
    assert round(bound, 4) == 0.0852
    assert ring_probe.l2_bytes(**kw) == 2 * 64 * 132 * 64 * 128 * 4
