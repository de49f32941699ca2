"""The AR kernel module's plain version (shallow_wavenet_tpu_torch.ops.
ar_kernel) against the JAX generators on the CPU: `generate_pallas` in
interpret mode and `generate_fast`, same plain params, conditioning and
uniforms.

Tolerances: Laplace at atol 1e-5 (fp32 sums in another order; the clip to
[-1, 1] bounds what the inverse CDF can amplify). Softmax in class ids:
the CDF sums run in another order, so a uniform within ~1e-7 of a bin edge
may pick the neighbouring class — at most 1 bin, on under 1% of samples.
Segmented generation is held to exact equality with one unsegmented call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.models import extract_plain_params
from shallow_wavenet_tpu.models.generate import generate_fast as jax_fast
from shallow_wavenet_tpu.models.generate import (
    generate_segmented as jax_segmented,
)
from shallow_wavenet_tpu.ops.ar_kernel import generate_pallas
from shallow_wavenet_tpu.ops.ar_kernel import warmup_length as jax_warmup
from shallow_wavenet_tpu.ops.mulaw import mulaw_quantize as jax_quantize
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.models.generate import (
    generate_fast, generate_segmented, seed_feedback,
)
from shallow_wavenet_tpu_torch.ops import ar_kernel

from tests.test_generate import setup_gen
from tests.test_model import randomize_head
from tests.test_torch_model import port_cfg, port_pp


def _gen(head, F=4, seed=0):
    """setup_gen with a random head2 (zero at init), so the feedback
    matters; the upsampler, hence c_up, does not depend on head2."""
    cfg, m, v, _, c_up = setup_gen(head, F=F, seed=seed)
    v = randomize_head(v)
    return cfg, m, v, extract_plain_params(v, cfg), np.array(c_up)


def _noise(shape, seed):
    return np.random.default_rng(seed).uniform(1e-6, 1 - 1e-6, shape).astype(
        np.float32)


def assert_same_samples(cfg, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if cfg.head == "laplace":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    q = cfg.quantize_channels
    d = np.abs(np.asarray(jax_quantize(got, q)).astype(int)
               - np.asarray(jax_quantize(want, q)).astype(int))
    assert d.max() <= 1, d.max()
    assert (d != 0).mean() < 0.01, (d != 0).mean()


def _port(pp, cfg, c_up, noise, **kw):
    """`ar_kernel.generate` on the CPU; the keywords that name a Layout
    field (fused, dtype, stream, chunk, ...) make the call's layout."""
    fields = {f.name for f in dataclasses.fields(ar_kernel.Layout)}
    layout = ar_kernel.Layout(**{k: kw.pop(k) for k in fields & set(kw)})
    return ar_kernel.generate(port_pp(pp), port_cfg(cfg),
                              torch.from_numpy(np.asarray(c_up)),
                              noise=torch.from_numpy(noise), device="cpu",
                              layout=layout, **kw).numpy()


@pytest.mark.parametrize("head", ["laplace", "softmax"])
@pytest.mark.parametrize("mode", ["sample", "greedy"])
def test_plain_matches_pallas_interpret_and_fast(head, mode):
    cfg, m, v, pp, c_up = _gen(head, F=6)
    B, T, _ = c_up.shape
    noise = _noise((B, T), 1)
    got = _port(pp, cfg, c_up, noise, mode=mode)
    pal = generate_pallas(pp, cfg, jnp.asarray(c_up), mode=mode,
                          noise=jnp.asarray(noise), chunk=64, interpret=True)
    fast = jax_fast(pp, cfg, jnp.asarray(c_up), jax.random.key(0), mode,
                    noise=jnp.asarray(noise))
    assert_same_samples(cfg, got, pal)
    assert_same_samples(cfg, got, fast)
    # the eager reference is the same plain version
    ref = generate_fast(port_pp(pp), port_cfg(cfg),
                        torch.from_numpy(np.asarray(c_up)),
                        noise=torch.from_numpy(noise), mode=mode,
                        device="cpu").numpy()
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("head", ["laplace", "softmax"])
def test_teacher_forced_matches_pallas_interpret(head):
    cfg, m, v, pp, c_up = _gen(head, F=6)
    B, T, _ = c_up.shape
    noise = _noise((B, T), 2)
    rng = np.random.default_rng(3)
    if head == "softmax":
        teacher = rng.integers(0, 256, (B, T)).astype(np.float32)
    else:
        teacher = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    got = _port(pp, cfg, c_up, noise, teacher=torch.from_numpy(teacher))
    want = generate_pallas(pp, cfg, jnp.asarray(c_up),
                           noise=jnp.asarray(noise),
                           teacher=jnp.asarray(teacher), chunk=64,
                           interpret=True)
    assert_same_samples(cfg, got, want)


@pytest.mark.parametrize("head", ["laplace", "softmax"])
def test_warmup_prefix_matches_pallas_interpret(head):
    """teacher + warmup: steps t < warmup forced, AR after; the teacher is
    shorter than T and padded with zeros, as in the JAX wrapper."""
    cfg, m, v, pp, c_up = _gen(head, F=12)
    B, T, _ = c_up.shape
    noise = _noise((B, T), 4)
    rng = np.random.default_rng(5)
    if head == "softmax":
        teacher = rng.integers(0, 256, (B, 64)).astype(np.float32)
    else:
        teacher = rng.uniform(-1, 1, (B, 64)).astype(np.float32)
    got = _port(pp, cfg, c_up, noise, teacher=torch.from_numpy(teacher),
                warmup=64)
    want = generate_pallas(pp, cfg, jnp.asarray(c_up),
                           noise=jnp.asarray(noise),
                           teacher=jnp.asarray(teacher), warmup=64, chunk=64,
                           interpret=True)
    assert_same_samples(cfg, got, want)


@pytest.mark.parametrize("head", ["laplace", "softmax"])
def test_segmented_matches_jax_and_equals_unsegmented(head):
    cfg, m, v, pp, c_up = _gen(head, F=30)          # T = 299
    B, T, _ = c_up.shape
    noise = _noise((B, T), 6)
    pcfg = port_cfg(cfg)
    c_t, n_t = torch.from_numpy(np.asarray(c_up)), torch.from_numpy(noise)
    seg = generate_segmented(port_pp(pp), pcfg, c_t, n_t, seg_len=128,
                             device="cpu").numpy()
    full = _port(pp, cfg, c_up, noise)
    np.testing.assert_array_equal(seg, full)
    want = jax_segmented(pp, cfg, np.asarray(c_up), noise, seg_len=128,
                         chunk=64, interpret=True)
    assert_same_samples(cfg, seg, want)


def test_warmup_length_and_seed_match_jax():
    from shallow_wavenet_tpu.config import get_config as jax_get_config
    from shallow_wavenet_tpu.models.generate import seed_feedback as jax_seed

    for name in ("shallow_softmax_single", "shallow_laplace_single",
                 "deep_baseline"):
        for chunk in (32, 64):
            assert (ar_kernel.warmup_length(get_config(name).model, chunk)
                    == jax_warmup(jax_get_config(name).model, chunk))
        assert (float(seed_feedback(get_config(name).model))
                == float(jax_seed(jax_get_config(name).model)))


def test_generator_noise_is_deterministic_and_in_range():
    cfg, m, v, pp, c_up = _gen("laplace")
    pcfg, ppp = port_cfg(cfg), port_pp(pp)
    c_t = torch.from_numpy(np.asarray(c_up))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return ar_kernel.generate(ppp, pcfg, c_t, generator=g, device="cpu")

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    u = ar_kernel.uniform_noise((4, 1000), torch.Generator().manual_seed(0))
    assert float(u.min()) >= 1e-7 and float(u.max()) <= 1 - 1e-7
