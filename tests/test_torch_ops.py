"""The port's small pieces against the JAX package on the CPU: mu-law codec,
output-head samplers, config presets; plus the port's package rules
(no JAX in its imports, CUDA by default, no silent CPU path) and the AR
kernel wrapper's argument checks."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.config import PRESETS as JAX_PRESETS
from shallow_wavenet_tpu.config import get_config as jax_get_config
from shallow_wavenet_tpu.models import heads as jax_heads
from shallow_wavenet_tpu.ops import mulaw as jax_mulaw
import shallow_wavenet_tpu_torch
from shallow_wavenet_tpu_torch.config import PRESETS, get_config
from shallow_wavenet_tpu_torch.models import heads
from shallow_wavenet_tpu_torch.ops import ar_kernel, mulaw

ROOT = Path(__file__).resolve().parent.parent


def test_mulaw_matches_jax():
    x = np.random.default_rng(0).uniform(-1, 1, 4096).astype(np.float32)
    x[:3] = (-1.0, 0.0, 1.0)
    xt = torch.from_numpy(x)
    # log1p and ** are library functions that may round 1 ulp apart on the
    # two sides; encode divides one log1p by another, so 2 ulp there
    np.testing.assert_array_max_ulp(
        mulaw.mulaw_encode(xt).numpy(), np.asarray(jax_mulaw.mulaw_encode(x)),
        maxulp=2)
    np.testing.assert_array_equal(
        mulaw.mulaw_quantize(xt).numpy(),
        np.asarray(jax_mulaw.mulaw_quantize(jnp.asarray(x))))
    # decode: 1 ulp of (1 + mu) ** |y| (up to 256), carried through the
    # -1 and the / mu — a step of spacing(255) / 255 in the result
    one_ulp = float(np.spacing(np.float32(255)) / 255)
    np.testing.assert_allclose(
        mulaw.mulaw_decode(xt).numpy(),
        np.asarray(jax_mulaw.mulaw_decode(jnp.asarray(x))), rtol=0,
        atol=one_ulp)
    ids = np.arange(256, dtype=np.int32)
    deq = mulaw.mulaw_dequantize(torch.from_numpy(ids))
    np.testing.assert_allclose(
        deq.numpy(), np.asarray(jax_mulaw.mulaw_dequantize(jnp.asarray(ids))),
        rtol=0, atol=one_ulp)
    # the bin centres quantize back to their ids (segmented softmax decode)
    np.testing.assert_array_equal(mulaw.mulaw_quantize(deq).numpy(), ids)


def test_laplace_from_uniform_matches_jax():
    rng = np.random.default_rng(1)
    out = rng.normal(0, 2, (512, 2)).astype(np.float32)
    u = rng.uniform(-0.5, 0.5, 512).astype(np.float32)
    u[:2] = (0.0, 0.49999)
    got = heads.laplace_from_uniform(torch.from_numpy(out), torch.from_numpy(u))
    want = jax_heads.laplace_from_uniform(jnp.asarray(out), jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_categorical_from_uniform_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (2048, 256)).astype(np.float32)
    u = rng.uniform(1e-7, 1 - 1e-7, 2048).astype(np.float32)
    got = heads.categorical_from_uniform(torch.from_numpy(logits),
                                         torch.from_numpy(u)).numpy()
    want = np.asarray(jax_heads.categorical_from_uniform(jnp.asarray(logits),
                                                         jnp.asarray(u)))
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 0.01, (d.max(), (d != 0).mean())


def test_config_is_the_jax_config():
    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    for name in PRESETS:
        ours = get_config(name, ["model.head=softmax"])
        assert ours.to_dict() == jax_get_config(
            name, ["model.head=softmax"]).to_dict()
        assert ours.model.dilations == jax_get_config(name).model.dilations
    # the copy is verbatim below its docstring
    body = (ROOT / "shallow_wavenet_tpu_torch/config.py").read_text()
    ref = (ROOT / "shallow_wavenet_tpu/config.py").read_text()
    assert body.split('"""', 2)[2] == ref.split('"""', 2)[2]


def test_port_imports_no_jax():
    """Every module of the port (a walk of the package, so none is missed)
    and chip_smoke.py import without JAX, flax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import shallow_wavenet_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'flax', "
        "'shallow_wavenet_tpu') or m.startswith(('jax.', 'jaxlib.', 'flax.', "
        "'shallow_wavenet_tpu.'))]\n"
        "need = {'ops.ar_kernel', 'ops.ar_probe', 'ops.ring_probe', "
        "'bin.decode', 'bin.kfuse', 'bin.kprobe', 'bin.dma_probe', "
        "'models.streaming', 'training.trainer', 'bin.train', 'ops.stft', "
        "'ops.filters', 'data.prefetch', 'data.synthetic', "
        "'parallel.mesh'}\n"
        "missing = [n for n in need if pkg.__name__ + '.' + n not in mods]\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)


def test_cuda_is_the_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shallow_wavenet_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shallow_wavenet_tpu_torch.resolve_device("cuda")
    assert shallow_wavenet_tpu_torch.resolve_device("cpu").type == "cpu"
    cfg = get_config("shallow_laplace_single").model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ar_kernel.generate({}, cfg, torch.zeros(1, 4, cfg.cond_channels),
                           mode="greedy")


def test_kernel_budget_check():
    """The recurrence's own preconditions raise on both versions; the
    kernel's limits (layers, classes, shared memory) are its C entry's,
    held on the card by chip_smoke.py."""
    for name in ("shallow_laplace_single", "shallow_softmax_single",
                 "deep_baseline"):
        ar_kernel.check_supported(get_config(name).model)
    with pytest.raises(ValueError, match="kernel_size"):
        ar_kernel.check_supported(
            get_config("shallow_laplace_single", ["model.kernel_size=3"]).model)
    with pytest.raises(ValueError, match="gate_channels"):
        ar_kernel.check_supported(get_config(
            "shallow_laplace_single", ["model.gate_channels=127"]).model)


def _tiny():
    cfg = get_config("shallow_softmax_single", [
        "model.head=laplace", "model.stack_size=2", "model.n_stacks=1"]).model
    from shallow_wavenet_tpu_torch.models.wavenet import (
        WaveNet, extract_plain_params, init_params_tree, params_from_flax,
    )
    m = params_from_flax(WaveNet(cfg), init_params_tree(cfg, seed=0))
    return cfg, extract_plain_params(m), torch.zeros(2, 10, cfg.cond_channels)


@pytest.mark.parametrize("kw, match", [
    (dict(cluster=-1), "cluster must be >= 0"),
    (dict(stream=True, cluster=8), "stream is ar_generate's"),
    (dict(resident=False), "it needs cluster=N"),
    (dict(wide=True), "the wide form needs"),
    (dict(wide=True, cluster=16), "the wide form needs"),
    (dict(wide=True, cluster=16, resident=False, dtype="bfloat16"),
     "the wide form needs"),
    (dict(wide=True, cluster=16, resident=False, fused=2),
     "the wide form needs"),
])
def test_layout_refuses_what_no_kernel_runs(kw, match):
    """Each combination of a layout's values that no kernel runs is
    refused where the layout is made."""
    with pytest.raises(ValueError, match=match):
        ar_kernel.Layout(**kw)


@pytest.mark.parametrize("kw, exc, match", [
    (dict(stream=True, chunk=48), ValueError, "chunk"),
    (dict(fused=-1), ValueError, "fused"),
    (dict(dtype="float16"), ValueError, "dtype"),
    (dict(warmup=4), ValueError, "teacher"),
    (dict(warmup=-1, teacher=torch.zeros(2, 10)), ValueError, "warmup"),
    (dict(unroll=0), ValueError, "unroll"),
    (dict(mode="beam"), ValueError, "mode"),
    (dict(noise=None), ValueError, "generator or noise"),
    (dict(noise=torch.full((2, 11), 0.5)), ValueError, "noise"),
    (dict(teacher=torch.zeros(3, 10)), ValueError, "teacher"),
])
def test_generate_argument_checks(kw, exc, match):
    cfg, pp, c_up = _tiny()
    fields = {f.name for f in dataclasses.fields(ar_kernel.Layout)}
    if fields & set(kw):
        # a layout's values: `Layout` refuses them where it is made, for
        # generate's layout and for generate_plain's dtype and window
        with pytest.raises(exc, match=match):
            ar_kernel.Layout(**kw)
        if set(kw) <= {"dtype", "fused"}:
            with pytest.raises(exc, match=match):
                ar_kernel.generate_plain(pp, cfg, c_up, device="cpu",
                                         noise=torch.full((2, 10), 0.5),
                                         **kw)
        return
    kw = {"noise": torch.full((2, 10), 0.5), **kw}
    for fn in (ar_kernel.generate, ar_kernel.generate_plain):
        with pytest.raises(exc, match=match):
            fn(pp, cfg, c_up, device="cpu", **kw)


def test_short_noise_and_teacher_are_padded():
    """A (B, <T) noise stream is padded with 0.5 and a teacher with zeros,
    as the JAX wrapper pads to whole chunks."""
    cfg, pp, c_up = _tiny()
    u = torch.rand(2, 10, generator=torch.Generator().manual_seed(0))
    full = torch.cat([u[:, :6], torch.full((2, 4), 0.5)], dim=1)
    a = ar_kernel.generate(pp, cfg, c_up, noise=u[:, :6], device="cpu")
    b = ar_kernel.generate(pp, cfg, c_up, noise=full, device="cpu")
    assert torch.equal(a, b)
    tch = torch.linspace(-0.5, 0.5, 10).repeat(2, 1)
    tch[:, 6:] = 0.0
    a = ar_kernel.generate(pp, cfg, c_up, noise=u, teacher=tch[:, :6],
                           device="cpu")
    b = ar_kernel.generate(pp, cfg, c_up, noise=u, teacher=tch, device="cpu")
    assert torch.equal(a, b)
