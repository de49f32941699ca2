"""The AR step's ablation probe (shallow_wavenet_tpu_torch.ops.ar_probe)
against the TPU probe `tools/kprobe.py` in interpret mode on the CPU, where
the port runs its plain version: the same numpy weights (carried by
`weights_from_jax`), conditioning and uniforms, every ablation, fp32 and
bf16.

The TPU probe pads its gate halves to 128 lanes and the port uses G/2, so
the config has G = 256. The TPU tool parses sys.argv when it is imported,
so it is loaded with its arguments patched, and its module globals B,
CHUNK and T are set before `build`, as its `run` reads them.

The weights are normal with std 0.2, four times the tool's recipe (whose
draw is checked on its own), so that every ablation and bf16's rounding
move the samples far past the limits. Tolerances: fp32 1e-5 (the two sides
sum the same products in other orders). bf16 5e-4: both sides round to
bf16 at the same points and sum exact products in fp32, but in other
orders, so now and then a value lands on the other side of a bf16 rounding
edge and the rings carry it (1.3e-4 seen on matmuls_only); the port at fp32
on the same weights, the control, must miss by more than 5x that. The same
limits hold for the plain version that sums in the kernel's order
(`chain=True`), which the card holds to the bit against the kernel. The JAX
side is compiled with XLA's excess precision off: with it on, XLA keeps
some bf16 values of the unrolled loops in fp32, and the tool's unroll2 and
unroll4 then differ from its own full.
"""

import importlib.util
import sys
from functools import lru_cache
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import shallow_wavenet_tpu.utils.compile_cache as compile_cache
from shallow_wavenet_tpu_torch.bin import kprobe
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.ops import ar_kernel, ar_probe

from tests.test_model import tiny_cfg
from tests.test_torch_model import port_cfg

ROOT = Path(__file__).resolve().parent.parent
CFG = tiny_cfg(gate_channels=256, residual_channels=8, skip_channels=16,
               n_stacks=2, stack_size=2, cond_channels=4)
B, CHUNK, T = 2, 4, 16
GP = 128                        # the TPU probe's gate half
STD = 0.2
TOL = {"float32": 1e-5, "bfloat16": 5e-4}
CONTROL_FACTOR = 5.0
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@lru_cache(maxsize=None)
def _tool():
    """tools/kprobe.py as a module, without its argv parsing or its
    persistent compilation cache."""
    spec = importlib.util.spec_from_file_location(
        "kprobe_tool", ROOT / "tools" / "kprobe.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(sys, "argv", ["kprobe.py"]), mock.patch.object(
            compile_cache, "enable_compilation_cache", lambda *a, **k: None):
        spec.loader.exec_module(mod)
    mod.B, mod.CHUNK, mod.T = B, CHUNK, T
    return mod


def _draw(wdt, std, seed=0, T=T, B=B):
    """The TPU probe's seven arrays in its order and shapes, then its
    conditioning and uniforms (`tools/kprobe.py:215-225`)."""
    rng = np.random.default_rng(seed)
    L, R = len(CFG.dilations), CFG.residual_channels
    S, C = CFG.skip_channels, CFG.cond_channels

    def mk(*shape):
        return jnp.asarray(rng.standard_normal(shape) * std, wdt)

    arrays = (mk(R), mk(L, 2, R, 2 * GP), mk(C, L * 2 * GP), mk(L, GP, R),
              mk(L, GP, S), mk(S, S), mk(S, 2))
    cond = rng.standard_normal((T, B, C)).astype(np.float32)
    noise = rng.uniform(0.01, 0.99, (T, B)).astype(np.float32)
    return arrays, cond, noise


@lru_cache(maxsize=None)
def _jax_want(ablate, dtype):
    """The TPU probe's samples of `ablate` on the test's draw."""
    arrays, cond, noise = _draw(JNP[dtype], STD)
    return _jax_probe(arrays, cond, noise, ablate, JNP[dtype])


def _jax_probe(arrays, cond, noise, ablate, wdt):
    """The TPU probe kernel of `ablate` in interpret mode, launched as its
    `run` launches it."""
    tool = _tool()
    kernel, sum_d = tool.build(CFG, ablate, wdt)
    R, C = CFG.residual_channels, CFG.cond_channels

    def wspec(w):
        return pl.BlockSpec(w.shape, lambda i, nd=w.ndim: (0,) * nd,
                            memory_space=pltpu.VMEM)

    call = pl.pallas_call(
        kernel, grid=(T // CHUNK,),
        in_specs=[pl.BlockSpec((CHUNK, B, C), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((CHUNK, B), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)]
        + [wspec(w) for w in arrays],
        out_specs=pl.BlockSpec((CHUNK, B), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((T, B), jnp.float32),
        scratch_shapes=[pltpu.VMEM((sum_d, B, R), wdt),
                        pltpu.VMEM((B, R), wdt)],
        interpret=True)
    args = (jnp.asarray(cond), jnp.asarray(noise), *arrays)
    compiled = jax.jit(call).lower(*args).compile(
        {"xla_allow_excess_precision": False})
    return np.asarray(compiled(*args))


def _port(weights, cond, noise, ablate, cfg=None, chain=False, **kw):
    fn = ar_probe.probe_plain if chain else ar_probe.probe
    extra = dict(chain=True) if chain else {}
    return fn(weights, cfg or port_cfg(CFG), torch.from_numpy(cond),
              torch.from_numpy(noise), ablate, chunk=CHUNK, device="cpu",
              **extra, **kw).numpy()


@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ablate", ar_probe.ABLATIONS)
def test_probe_matches_jax_tool(ablate, dtype, chain):
    arrays, cond, noise = _draw(JNP[dtype], STD)
    want = _jax_want(ablate, dtype)
    w = ar_probe.weights_from_jax(arrays)
    assert all(v.dtype == ar_kernel.DTYPES[dtype] for v in w.values())
    got = _port(w, cond, noise, ablate, chain=chain)
    assert got.shape == (T, B) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)
    if dtype == "bfloat16":
        control = _port({k: v.float() for k, v in w.items()}, cond, noise,
                        ablate)
        assert np.abs(control - want).max() > CONTROL_FACTOR * TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ablate", ar_probe.SCHEDULES + ("gate_bf16",))
def test_schedules_compute_full(ablate, dtype):
    """unroll2, unroll4 and split2 are schedules of full's function, and so
    is gate_bf16 in fp32; every other ablation changes the samples."""
    arrays, cond, noise = _draw(JNP[dtype], STD)
    w = ar_probe.weights_from_jax(arrays)
    full = _port(w, cond, noise, "full")
    got = _port(w, cond, noise, ablate)
    if ablate == "gate_bf16" and dtype == "bfloat16":
        assert np.abs(got - full).max() > 10 * TOL[dtype]
    else:
        np.testing.assert_array_equal(got, full)
    for other in ("no_cond", "no_prev", "no_buf", "no_gate"):
        assert np.abs(_port(w, cond, noise, other) - full).max() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recipe_is_the_jax_tools(dtype):
    """`probe_weights` draws the TPU probe's recipe (std 0.05, seed 0) in
    its order, shapes and dtype, where gp = G/2."""
    arrays, _, _ = _draw(JNP[dtype], 0.05)
    want = ar_probe.weights_from_jax(arrays)
    got = ar_probe.probe_weights(port_cfg(CFG), dtype)
    assert list(got) == list(ar_probe.WEIGHTS)
    for k in ar_probe.WEIGHTS:
        assert got[k].dtype == want[k].dtype
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # the carrier's layout: cond_wcat's layer-l columns are cond_w[l]
    G = CFG.gate_channels
    for l in range(len(CFG.dilations)):
        np.testing.assert_array_equal(
            got["cond_w"][l].float().numpy(),
            np.asarray(arrays[2][:, l * G:(l + 1) * G], np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_is_the_production_step(dtype):
    """On unit input weights and zero biases (`plain_params`), full is the
    production kernel's function: its plain version at the same limits."""
    arrays, cond, noise = _draw(JNP[dtype], STD)
    w = ar_probe.weights_from_jax(arrays)
    got = _port(w, cond, noise, "full")
    want = ar_kernel.generate_plain(
        ar_probe.plain_params(w), port_cfg(CFG),
        torch.from_numpy(cond).transpose(0, 1), device="cpu",
        noise=torch.from_numpy(noise).t(), dtype=dtype).numpy()
    np.testing.assert_allclose(got, want.T, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ablate", ["full", "no_cond", "no_buf", "no_head",
                                    "gate_bf16"])
def test_feedback_replays_own_samples(ablate, dtype, chain):
    """Fed its own samples, one step late, the plain version (which, so
    forced, runs the whole call layer by layer) repeats its step-by-step
    run exactly; fed other samples, it follows them."""
    arrays, cond, noise = _draw(JNP[dtype], STD)
    w = ar_probe.weights_from_jax(arrays)
    kw = dict(ablate=ablate, chunk=CHUNK, device="cpu", chain=chain)
    c, n = torch.from_numpy(cond), torch.from_numpy(noise)
    out = ar_probe.probe_plain(w, port_cfg(CFG), c, n, **kw)
    own = torch.cat([torch.zeros(1, B), out[:-1]]).t()
    replay = ar_probe.probe_plain(w, port_cfg(CFG), c, n, feedback=own, **kw)
    torch.testing.assert_close(replay, out, rtol=0, atol=0)
    other = ar_probe.probe_plain(w, port_cfg(CFG), c, n,
                                 feedback=torch.zeros(B, T), **kw)
    assert not torch.equal(other, out)


def test_feedback_replays_a_call_shorter_than_its_dilations():
    """Forced over fewer steps than a layer's dilation, that layer's ring
    is never read back: still the step-by-step run."""
    cfg = port_cfg(tiny_cfg(gate_channels=256, residual_channels=8,
                            skip_channels=16, n_stacks=1, stack_size=4,
                            cond_channels=4))
    w = {k: v * 4 for k, v in ar_probe.probe_weights(cfg).items()}
    rng = np.random.default_rng(1)
    c = torch.from_numpy(rng.standard_normal((4, B, 4)).astype(np.float32))
    n = torch.from_numpy(rng.uniform(0.01, 0.99, (4, B)).astype(np.float32))
    out = ar_probe.probe_plain(w, cfg, c, n, "full", chunk=4, device="cpu")
    own = torch.cat([torch.zeros(1, B), out[:-1]]).t()
    replay = ar_probe.probe_plain(w, cfg, c, n, "full", chunk=4,
                                  device="cpu", feedback=own)
    assert max(cfg.dilations) > 4
    torch.testing.assert_close(replay, out, rtol=0, atol=0)


@pytest.mark.parametrize("cfg_over, ablate, batch, chunk, match", [
    ([], "no_resskip", 2, 4, "no_resskip"),          # config 2: S > G/2
    (["model.skip_channels=64"], "no_resskip", 2, 4, None),
    ([], "split2", 3, 4, "even batch"),
    ([], "full", 2, 6, "chunk"),
    ([], "full", 2, 32, "chunk"),                     # does not divide T
    ([], "no_such", 2, 4, "unknown ablation"),
])
def test_undefined_shapes_are_refused(cfg_over, ablate, batch, chunk, match):
    """Both versions refuse, before any step, what an ablation cannot
    take; the TPU tool fails the same way (deep_baseline's no_resskip)."""
    cfg = get_config("shallow_laplace_single", cfg_over).model
    w = ar_probe.probe_weights(cfg)
    cond = torch.zeros(8, batch, cfg.cond_channels)
    noise = torch.full((8, batch), 0.5)
    for fn in (ar_probe.probe, ar_probe.probe_plain):
        if match is None:
            assert fn(w, cfg, cond, noise, ablate, chunk=chunk,
                      device="cpu").shape == (8, batch)
        else:
            with pytest.raises(ValueError, match=match):
                fn(w, cfg, cond, noise, ablate, chunk=chunk, device="cpu")


@pytest.mark.parametrize("bad, match", [
    (dict(cond=torch.zeros(8, 2, 3)), "cond"),
    (dict(noise=torch.zeros(2, 8)), "noise"),
    (dict(drop="h2_w"), "probe weights are"),
    (dict(shape=("res_w", (4, 128, 9))), "res_w"),
    (dict(mixed="h1_w"), "one dtype"),
    (dict(feedback=torch.zeros(8, 2)), "feedback"),
])
def test_argument_checks(bad, match):
    cfg = port_cfg(CFG)
    w = ar_probe.probe_weights(cfg)
    args = dict(cond=torch.zeros(8, 2, CFG.cond_channels),
                noise=torch.full((8, 2), 0.5))
    kw = {}
    if "drop" in bad:
        del w[bad["drop"]]
    elif "shape" in bad:
        w[bad["shape"][0]] = torch.zeros(bad["shape"][1])
    elif "mixed" in bad:
        w[bad["mixed"]] = w[bad["mixed"]].bfloat16()
    elif "feedback" in bad:
        kw = bad
    else:
        args.update(bad)
    with pytest.raises(ValueError, match=match):
        ar_probe.probe_plain(w, cfg, args["cond"], args["noise"], "full",
                             chunk=4, device="cpu", **kw)


def test_probe_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_cfg(CFG)
    w = ar_probe.probe_weights(cfg)
    cond = torch.zeros(8, 2, CFG.cond_channels)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ar_probe.probe(w, cfg, cond, torch.full((8, 2), 0.5), "full",
                           chunk=4, device=device)
    assert not ar_probe.launches


@pytest.mark.parametrize("kw, error", [
    (dict(steps=100), ValueError),             # not whole chunks
    (dict(only=["no_such"]), ValueError),
    (dict(device="cpu"), RuntimeError),        # it times the CUDA kernel
])
def test_kprobe_sweep_refuses_before_any_launch(kw, error):
    with pytest.raises(error):
        kprobe.sweep(**kw)
    assert not ar_probe.launches


def test_weights_per_step_counts_what_each_ablation_reads():
    cfg = get_config("shallow_laplace_single").model
    full = kprobe.weights_per_step(cfg, "full", 128)
    L, R, G, S, C = 12, 64, 128, 128, 64
    assert full == R + L * (2 * R * G + C * G + (G // 2) * (S + R)) + S * S \
        + 2 * S
    assert kprobe.weights_per_step(cfg, "no_prev", 128) == full - L * R * G
    assert kprobe.weights_per_step(cfg, "no_head", 128) == full - S * S - 2 * S
    assert kprobe.weights_per_step(cfg, "no_cond", 128) == pytest.approx(
        full - L * C * G * 127 / 128)
    for ab in ar_probe.SCHEDULES + ("no_buf", "no_sample", "cheap_gate"):
        assert kprobe.weights_per_step(cfg, ab, 128) == full
