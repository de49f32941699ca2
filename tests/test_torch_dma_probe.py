"""The ring-window copy probe (shallow_wavenet_tpu_torch.ops.ring_probe)
against the TPU probe `tools/dma_probe.py` in interpret mode on the CPU,
where the port runs its plain version. The probe's values are small
integers, so every comparison is exact."""

import importlib.util
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from shallow_wavenet_tpu_torch.bin import dma_probe
from shallow_wavenet_tpu_torch.ops import ring_probe

ROOT = Path(__file__).resolve().parent.parent


@lru_cache(maxsize=None)
def _tool():
    spec = importlib.util.spec_from_file_location(
        "dma_probe_tool", ROOT / "tools" / "dma_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_out():
    """The TPU probe's output, launched as its `main` launches it, in
    interpret mode."""
    t = _tool()
    out, _ = pl.pallas_call(
        t.kernel,
        grid=(t.N_CHUNKS,),
        in_specs=[],
        out_specs=[
            pl.BlockSpec((t.CHUNK, t.B, t.R), lambda i: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((t.N_CHUNKS * t.CHUNK, t.B, t.R),
                                 jnp.float32),
            jax.ShapeDtypeStruct((t.PER * t.CHUNK, t.B, t.R), jnp.float32),
        ],
        scratch_shapes=[
            pltpu.VMEM((t.CHUNK, t.B, t.R), jnp.float32),
            pltpu.SemaphoreType.DMA(()),
        ],
        interpret=True,
    )()
    return np.asarray(out)


def test_plain_matches_jax_tool():
    t = _tool()
    shape = ring_probe.SHAPES["jax"]
    assert shape == dict(chunk=t.CHUNK, batch=t.B, channels=t.R, per=t.PER,
                         n_chunks=t.N_CHUNKS)
    want = _jax_out()
    got = ring_probe.ring_probe_plain(**shape, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    # the tool's own check: chunk i holds i // PER + 1
    np.testing.assert_array_equal(
        want.reshape(t.N_CHUNKS, -1)[:, 0],
        np.arange(t.N_CHUNKS) // t.PER + 1.0)


@pytest.mark.parametrize("variant", ring_probe.VARIANTS)
def test_variants_match_jax_tool(variant):
    """Every variant's call on the CPU (the plain path, through the wrapper
    and through `ring_probe_into` on buffers made by the caller) against the
    TPU probe in interpret mode at its shape."""
    shape = ring_probe.SHAPES["jax"]
    want = _jax_out()
    got = ring_probe.ring_probe(**shape, variant=variant, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    ring = torch.zeros((shape["batch"], shape["per"] * shape["chunk"],
                        shape["channels"]))
    out = torch.empty(want.shape)
    assert ring_probe.ring_probe_into(ring, out, shape["chunk"],
                                      shape["per"], variant) is out
    np.testing.assert_array_equal(out.numpy(), want)
    assert not ring_probe.launches


@pytest.mark.parametrize("per, n_chunks", [(1, 3), (2, 8), (3, 7), (4, 9),
                                           (5, 2)])
def test_plain_is_the_closed_form(per, n_chunks):
    kw = dict(chunk=3, batch=2, channels=4, per=per, n_chunks=n_chunks)
    got = ring_probe.ring_probe_plain(**kw, device="cpu")
    assert got.shape == (n_chunks * 3, 2, 4)
    torch.testing.assert_close(got, ring_probe.expected(**kw), rtol=0,
                               atol=0)


@pytest.mark.parametrize("variant", ring_probe.VARIANTS)
def test_cpu_call_runs_the_plain_version(variant):
    kw = ring_probe.SHAPES["jax"]
    got = ring_probe.ring_probe(**kw, variant=variant, device="cpu")
    torch.testing.assert_close(got, ring_probe.expected(**kw), rtol=0,
                               atol=0)
    assert not ring_probe.launches


@pytest.mark.parametrize("kw, match", [
    (dict(variant="dma"), "variant"),
    (dict(channels=6), "multiple of 4"),
    (dict(per=0), "per"),
])
def test_shape_checks(kw, match):
    with pytest.raises(ValueError, match=match):
        ring_probe.ring_probe(**kw, device="cpu")


def test_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ring_probe.ring_probe(device=device)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        dma_probe.run("jax", "tma", device="cpu")
    assert dma_probe.main([]) == 1
    assert not ring_probe.launches


def test_moved_bytes():
    """Three windows per chunk and row: in, out and back."""
    assert ring_probe.moved_bytes(**ring_probe.SHAPES["rate"]) == \
        3 * 64 * 132 * 64 * 128 * 4
