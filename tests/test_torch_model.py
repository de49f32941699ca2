"""Torch WaveNet (shallow_wavenet_tpu_torch.models.wavenet) against the flax
WaveNet on the CPU: same parameter tree, same inputs from a numpy seed.

Tolerances: atol 1e-5 (fp32 sums in another order), under fp32 and under
bf16 compute_dtype alike. Under bf16 both sides round to bf16 at the same
places, so they meet to fp32 rounding: the measured errors are 0 for the
upsampled conditioning and at most 4.5e-8 for the head output (seeds 5-7,
both heads). The bf16 test also runs a control, the port at fp32 compute
on the same weights, which is 2.4e-3..4.0e-3 from the JAX bf16 output and
8e-3..1.5e-2 from its conditioning: a port that dropped a bf16 cast fails.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.models import WaveNet as FlaxWaveNet
from shallow_wavenet_tpu.models import extract_plain_params as flax_plain
from shallow_wavenet_tpu_torch.config import ModelConfig as PortModelConfig
from shallow_wavenet_tpu_torch.models.wavenet import (
    WaveNet, extract_plain_params, init_params_tree, load_params_npz,
    params_from_flax, save_params_npz,
)

from tests.test_model import make_inputs, randomize_head, tiny_cfg


def port_cfg(cfg):
    """The JAX ModelConfig as the port's (identical fields)."""
    return PortModelConfig(**dataclasses.asdict(cfg))


def flax_tree(variables):
    return jax.tree.map(np.asarray, variables["params"])


def port_model(cfg, variables):
    return params_from_flax(WaveNet(port_cfg(cfg)), flax_tree(variables))


def port_pp(pp):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in pp.items()}


def _setup(cfg, B=2, F=6, seed=0, spk=None):
    m = FlaxWaveNet(cfg)
    x, c, _ = make_inputs(cfg, B=B, F=F, seed=seed)
    v = randomize_head(m.init(jax.random.key(seed + 3), x, c, spk))
    return m, v, x, c


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("head", ["laplace", "softmax"])
@pytest.mark.parametrize("fold", [False, True])
def test_forward_matches_flax_fp32(head, fold):
    cfg = tiny_cfg(head=head, n_stacks=2, stack_size=3, fold_taps=fold)
    m, v, x, c = _setup(cfg, B=3, F=7, seed=1)
    want = np.asarray(m.apply(v, x, c))
    with torch.no_grad():
        got = port_model(cfg, v)(_t(x), _t(c)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_stack_and_upsample_match_flax_fp32():
    cfg = tiny_cfg(n_stacks=2, stack_size=3)
    m, v, x, c = _setup(cfg, seed=2)
    pm = port_model(cfg, v)
    c_up_j = m.apply(v, c, method="upsample_cond")
    with torch.no_grad():
        c_up_t = pm.upsample_cond(_t(c))
        np.testing.assert_allclose(c_up_t.numpy(), np.asarray(c_up_j),
                                   atol=1e-5, rtol=0)
        t = x.shape[1]
        got = pm.stack(_t(x), c_up_t[:, :t]).numpy()
    want = np.asarray(m.apply(v, x, c_up_j[:, :t], method="stack"))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_upsample_valid_frames_and_speaker_match_flax():
    cfg = tiny_cfg(n_speakers=3)
    spk = jnp.asarray([2, 0], jnp.int32)
    m, v, x, c = _setup(cfg, F=8, seed=4, spk=spk)
    valid = jnp.asarray([8, 5], jnp.int32)
    want = np.asarray(m.apply(v, c, spk, valid, method="upsample_cond"))
    with torch.no_grad():
        got = port_model(cfg, v).upsample_cond(_t(c), _t(spk), _t(valid))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    hop = int(np.prod(cfg.upsample_factors))
    assert np.all(got.numpy()[1, 5 * hop:] == 0)
    # __call__ with the speaker path
    want = np.asarray(m.apply(v, x, c, spk))
    with torch.no_grad():
        got = port_model(cfg, v)(_t(x), _t(c), _t(spk)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("head", ["laplace", "softmax"])
def test_forward_matches_flax_bf16(head):
    cfg = tiny_cfg(head=head, n_stacks=2, stack_size=3,
                   compute_dtype="bfloat16")
    m, v, x, c = _setup(cfg, B=3, F=7, seed=5)
    want = np.asarray(m.apply(v, x, c))
    c_up_j = np.asarray(m.apply(v, c, method="upsample_cond"))
    with torch.no_grad():
        pm = port_model(cfg, v)
        got = pm(_t(x), _t(c)).numpy()
        c_up_t = pm.upsample_cond(_t(c)).numpy()
        # control: the same weights at fp32 compute
        pm32 = port_model(dataclasses.replace(cfg, compute_dtype="float32"), v)
        got32 = pm32(_t(x), _t(c)).numpy()
        c_up32 = pm32.upsample_cond(_t(c)).numpy()
    for a, a32, b in ((c_up_t, c_up32, c_up_j), (got, got32, want)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        assert np.abs(a32 - b).max() > 100 * 1e-5


def _upsampler_setup(compute_dtype, F=7, seed=8):
    cfg = tiny_cfg(upsample_factors=(2, 3, 2), compute_dtype=compute_dtype)
    m, v, _, c = _setup(cfg, B=3, F=F, seed=seed)
    return cfg, port_model(cfg, v), _t(c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prebuilt_phase_weights_are_each_stages(dtype):
    """ConditioningUpsampler.phase_weights() gives every stage's
    phase_weights(), to the bit, in stage order."""
    _, pm, _ = _upsampler_setup(dtype)
    up = pm.upsampler
    with torch.no_grad():
        got = up.phase_weights()
        want = [getattr(up, f"smooth{i}").phase_weights()
                for i in range(len(up.factors))]
    assert len(got) == len(want) == 3
    for g, w, f in zip(got, want, up.factors):
        assert g.shape == (3 * 12, f * 12)
        assert torch.equal(g, w)


@pytest.mark.parametrize("valid", [None, [7, 4, 1]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsampler_with_prebuilt_phase_weights(dtype, valid):
    """forward with the phase weights made once gives the outputs of
    forward building them, to the bit, with `valid` set and unset."""
    cfg, pm, c = _upsampler_setup(dtype)
    valid = None if valid is None else torch.tensor(valid)
    with torch.no_grad():
        phase = pm.upsampler.phase_weights()
        want = pm.upsample_cond(c, valid_frames=valid)
        got = pm.upsample_cond(c, valid_frames=valid, phase=phase)
        assert torch.equal(got, want)
        assert torch.equal(pm.upsampler(c, valid, phase),
                           pm.upsampler(c, valid))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_right_padded_window_equals_the_window(dtype, monkeypatch):
    """Windows right-padded to the longest (padding of any value) and
    upsampled in one call with `valid` = their own lengths and `windows`
    give each unpadded window's rows to the bit, and zeros past them;
    every product is taken per window, at the window's own shape."""
    cfg, pm, c = _upsampler_setup(dtype, F=9)
    hop = int(np.prod(cfg.upsample_factors))
    rng = np.random.default_rng(3)
    lens = [9, 6, 1]
    padded = c.clone()
    for i, n in enumerate(lens):
        padded[i, n:] = torch.from_numpy(rng.standard_normal(
            (9 - n, cfg.aux_channels)).astype(np.float32))
    shapes = []
    matmul = torch.matmul

    def recorded(x, w):
        shapes.append(tuple(x.shape[:2]))
        return matmul(x, w)

    with torch.no_grad():
        phase = pm.upsampler.phase_weights()
        monkeypatch.setattr(torch, "matmul", recorded)
        got = pm.upsample_cond(padded, valid_frames=torch.tensor(lens),
                               phase=phase, windows=[(1, n) for n in lens])
        monkeypatch.undo()
        rates = np.cumprod((1,) + cfg.upsample_factors[:-1])
        assert shapes == [(1, n * r) for r in (1, *rates) for n in lens]
        for i, n in enumerate(lens):
            alone = pm.upsample_cond(c[i:i + 1, :n])
            assert torch.equal(got[i:i + 1, :n * hop], alone)
            assert not got[i, n * hop:].any()


def test_extract_plain_params_matches_flax():
    for head in ("laplace", "softmax"):
        cfg = tiny_cfg(head=head)
        m, v, _, _ = _setup(cfg, seed=6)
        want = flax_plain(v, cfg)
        got = extract_plain_params(port_model(cfg, v))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].dtype == torch.float32


def test_params_npz_roundtrip_and_random_tree_layout(tmp_path):
    """save/load keeps every leaf; init_params_tree has the flax tree's
    keys and shapes, so random weights load into the module."""
    for kw in (dict(head="laplace", n_speakers=2), dict(head="softmax")):
        cfg = tiny_cfg(**kw)
        spk = jnp.zeros((2,), jnp.int32) if kw.get("n_speakers") else None
        _, v, _, _ = _setup(cfg, seed=7, spk=spk)
        tree = flax_tree(v)
        save_params_npz(tmp_path / "p.npz", tree)
        back = load_params_npz(tmp_path / "p.npz")
        flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (_, a), (_, b) in zip(flat_a, flat_b):
            np.testing.assert_array_equal(a, b)
        rnd = init_params_tree(port_cfg(cfg), seed=1)
        assert (jax.tree.map(np.shape, rnd)
                == jax.tree.map(np.shape, dict(tree)))
        params_from_flax(WaveNet(port_cfg(cfg)), rnd)
