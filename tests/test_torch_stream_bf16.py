"""The AR kernel's streamed-ring and bf16 variants (shallow_wavenet_tpu_torch.
ops.ar_kernel with stream=True / dtype="bfloat16") against the JAX
`generate_pallas` in interpret mode on the CPU, where the port runs its
plain version: same plain params, conditioning, uniforms and teacher.

Tolerances. Streamed: as in test_torch_generate (Laplace atol 1e-5, softmax
class ids within 1 bin on under 1% of samples), and exact equality with the
resident layout, since where a ring is stored changes no arithmetic. bf16,
teacher-forced: both sides round to bf16 at the same points and sum exact
products in fp32, so they meet to fp32 rounding (measured 6e-8..1.2e-7 over
seeds 0-2); held at atol 1e-5, and the port at fp32 on the same inputs, the
control, is 1.3e-3..2.6e-3 from JAX's bf16 output and must miss by 10x the
limit: a plain version that dropped a bf16 rounding fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.config import get_config as jax_get_config
from shallow_wavenet_tpu.models import WaveNet as FlaxWaveNet
from shallow_wavenet_tpu.models import extract_plain_params
from shallow_wavenet_tpu.ops.ar_kernel import _stream_split as jax_split
from shallow_wavenet_tpu.ops.ar_kernel import generate_pallas
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.models.generate import generate_segmented
from shallow_wavenet_tpu_torch.ops import ar_kernel

from tests.test_model import randomize_head, tiny_cfg
from tests.test_torch_generate import _gen, _noise, _port, assert_same_samples
from tests.test_torch_model import port_cfg, port_pp


def _big_dil(head, stack_size=8, n_chunks=5, B=2, seed=0):
    """The big-dilation config of tests/test_pallas_ar.py (top dilation
    128 > chunk 64, so two layers stream), with a random head2."""
    cfg = tiny_cfg(head=head, n_stacks=2, stack_size=stack_size,
                   upsample_factors=(8, 8))
    m = FlaxWaveNet(cfg)
    rng = np.random.default_rng(seed)
    F = n_chunks
    x = jnp.zeros((B, F * 64 - 1), jnp.int32 if head == "softmax"
                  else jnp.float32)
    c = jnp.asarray(rng.standard_normal((B, F, cfg.aux_channels)), jnp.float32)
    v = randomize_head(m.init(jax.random.key(3), x, c))
    c_up = np.array(m.apply(v, c, method="upsample_cond"))
    return cfg, extract_plain_params(v, cfg), c_up


def _teacher(head, shape, seed):
    rng = np.random.default_rng(seed)
    if head == "softmax":
        return rng.integers(0, 256, shape).astype(np.float32)
    return rng.uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("name", ["deep_baseline", "big_dilation"])
@pytest.mark.parametrize("chunk", [32, 64])
def test_stream_split_matches_jax(name, chunk):
    if name == "deep_baseline":
        dil = get_config(name).model.dilations
        assert dil == jax_get_config(name).model.dilations
    else:
        dil = tiny_cfg(n_stacks=2, stack_size=8).dilations
    for stream in (False, True):
        assert (ar_kernel.stream_split(dil, chunk, stream)
                == jax_split(dil, chunk, stream))
    assert ar_kernel.stream_split(dil, chunk, True)[1]


@pytest.mark.parametrize("head", ["laplace", "softmax"])
@pytest.mark.parametrize("forced", [False, True])
def test_streamed_matches_pallas_interpret(head, forced):
    cfg, pp, c_up = _big_dil(head)
    assert jax_split(cfg.dilations, 64, True)[1]
    B, T, _ = c_up.shape
    noise = _noise((B, T), 11)
    kw = {}
    if forced:
        kw["teacher"] = _teacher(head, (B, T), 12)
    got = _port(pp, cfg, c_up, noise, stream=True, chunk=64,
                **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = generate_pallas(pp, cfg, jnp.asarray(c_up),
                           noise=jnp.asarray(noise), chunk=64,
                           interpret=True, stream=True,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    assert_same_samples(cfg, got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_equals_resident(dtype):
    cfg, pp, c_up = _big_dil("laplace", n_chunks=4)
    B, T, _ = c_up.shape
    noise = _noise((B, T), 13)
    resident = _port(pp, cfg, c_up, noise, dtype=dtype)
    for chunk in (32, 64):
        streamed = _port(pp, cfg, c_up, noise, stream=True, chunk=chunk,
                         dtype=dtype)
        np.testing.assert_array_equal(streamed, resident)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_teacher_forced_matches_pallas_interpret(seed):
    cfg, m, v, pp, c_up = _gen("laplace", F=6, seed=seed)
    B, T, _ = c_up.shape
    noise = _noise((B, T), 2 + seed)
    teacher = _teacher("laplace", (B, T), 3 + seed)
    want = np.asarray(generate_pallas(
        pp, cfg, jnp.asarray(c_up), noise=jnp.asarray(noise),
        teacher=jnp.asarray(teacher), chunk=64, interpret=True,
        dtype="bfloat16"))
    t = torch.from_numpy(teacher)
    got = _port(pp, cfg, c_up, noise, teacher=t, dtype="bfloat16")
    control = _port(pp, cfg, c_up, noise, teacher=t)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(control - want).max() > 10 * 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_sum_plain_matches_pallas_interpret(dtype):
    """The plain version's `chain` mode (every dot one fp32 chain in k
    order, the kernel's order) on the inputs of the bf16 test above, held
    at its limit: only the order of the fp32 sums differs from matmuls."""
    cfg, m, v, pp, c_up = _gen("laplace", F=6, seed=0)
    B, T, _ = c_up.shape
    noise = _noise((B, T), 2)
    teacher = _teacher("laplace", (B, T), 3)
    want = np.asarray(generate_pallas(
        pp, cfg, jnp.asarray(c_up), noise=jnp.asarray(noise),
        teacher=jnp.asarray(teacher), chunk=64, interpret=True, dtype=dtype))
    got = ar_kernel.generate_plain(
        port_pp(pp), port_cfg(cfg), torch.from_numpy(c_up),
        noise=torch.from_numpy(noise), teacher=torch.from_numpy(teacher),
        device="cpu", dtype=dtype, chain=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmented_streamed_equals_unsegmented(dtype):
    """stack_size 7: top dilation 64, streamed at chunk 32; the warm-start
    is warmup_length(cfg, 32) = 256 steps, so seg_len 288 gives two
    segments over T = 383."""
    cfg, pp, c_up = _big_dil("laplace", stack_size=7, n_chunks=6)
    pcfg, ppp = port_cfg(cfg), port_pp(pp)
    assert ar_kernel.warmup_length(pcfg, 32) == 256
    B, T, _ = c_up.shape
    c_t, n_t = torch.from_numpy(c_up), torch.from_numpy(_noise((B, T), 14))
    kw = dict(chunk=32, stream=True, dtype=dtype, device="cpu")
    seg = generate_segmented(ppp, pcfg, c_t, n_t, 288, **kw)
    full = ar_kernel.generate(ppp, pcfg, c_t, noise=n_t, **kw)
    torch.testing.assert_close(seg, full, rtol=0, atol=0)
