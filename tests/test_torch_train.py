"""The port's Trainer (shallow_wavenet_tpu_torch.training) against the JAX
Trainer on the CPU: one flax init, the same numpy batches.

- The first step's loss and per-leaf gradients (head2 randomized, so every
  leaf but the last layer's unused `res` has a gradient): the loss within
  1e-5 relative; each leaf's largest gradient error within 1e-5 of the
  leaf's largest entry in fp32 (measured 4.7e-7), and within 2e-2 in bf16
  compute (measured 9.3e-3, at input_proj: the port's collapsed
  phase-matmul upsampler rounds its backward to bf16 at other points than
  JAX's repeat + conv, about one bf16 ulp).
- 25-step loss trajectories (clip 10, Adam): fp32 at atol 1e-4 (measured
  9.5e-7), bf16 at atol 1e-3 (measured 4.5e-4), inside the 5e-3 contract
  of tests/test_train_parity_torch.py; for both heads, the speaker path,
  an lr decay and weight decay. The fp32 final parameters within 1e-5.
- The optimizer alone against the JAX Trainer's optax chain on given
  gradients, clip active and not: within 1e-6 (fp32 rounding of the same
  ops). It pins the two places where PyTorch's stock pieces differ: optax
  scales by max/norm only when norm >= max (clip_grad_norm_ uses
  max/(norm + 1e-6)), and adamw decays every leaf, including the ones the
  loss does not reach (torch.optim skips a None gradient).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.models import heads as jax_heads
from shallow_wavenet_tpu.training import Trainer as JaxTrainer
from shallow_wavenet_tpu_torch.config import Config
from shallow_wavenet_tpu_torch.models import heads
from shallow_wavenet_tpu_torch.models.wavenet import _flatten
from shallow_wavenet_tpu_torch.training import Trainer

from tests.test_model import randomize_head
from tests.test_train_parity_torch import N_STEPS, _batches, _cfg

UNUSED = ("layer2/res/kernel", "layer2/res/bias")   # the last layer's res


def _setup(head, n_speakers, dtype, **train):
    cfg = _cfg(head, n_speakers)
    cfg.model = dataclasses.replace(cfg.model, compute_dtype=dtype)
    cfg.train = dataclasses.replace(cfg.train, **train)
    jt = JaxTrainer(cfg, mesh=None)
    return cfg, jt, Trainer(Config.from_dict(cfg.to_dict()), device="cpu")


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _leaf_errors(want: dict, got: dict) -> dict:
    return {k: float(np.abs(want[k] - got[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want}


CASES = [
    ("laplace", 0, "float32", {}),
    ("softmax", 0, "float32", {}),
    ("laplace", 2, "float32", {}),
    ("laplace", 0, "bfloat16", {}),
    ("softmax", 0, "bfloat16", {}),
    ("laplace", 2, "bfloat16", {}),
    ("laplace", 0, "float32", {"lr_decay_steps": 10, "lr_decay_rate": 0.5}),
    ("laplace", 0, "float32", {"weight_decay": 1e-2}),
    ("laplace", 0, "bfloat16", {"weight_decay": 1e-2}),
]


@pytest.mark.parametrize("head,n_speakers,dtype,train", CASES)
def test_first_step_and_trajectory_track_jax(head, n_speakers, dtype, train):
    cfg, jt, pt = _setup(head, n_speakers, dtype, **train)
    batches = _batches(cfg, N_STEPS)
    init = jt.init_state()

    # the first step's loss and gradients, with a head that has signal
    warm = randomize_head({"params": init.params}, seed=5)["params"]
    jl, jg = jax.jit(jax.value_and_grad(jt._loss_fn))(
        warm, jt.shard_batch(batches[0]))
    pl, pg = pt.value_and_grad(pt.init_state(tree=_np_tree(warm)),
                               batches[0])
    assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    want, got = _flatten(_np_tree(jg)), _flatten(pt.params_tree(pg))
    assert set(want) == set(got)
    errs = _leaf_errors({k: v for k, v in want.items() if k not in UNUSED},
                        got)
    assert max(errs.values()) <= (1e-5 if dtype == "float32" else 2e-2), errs
    for k in UNUSED:      # zero, not missing, on both sides
        assert not want[k].any() and not got[k].any()

    # 25 updates from the flax init (the JAX step donates its state)
    first = _flatten(_np_tree(init.params))
    ps, losses = pt.init_state(tree=_np_tree(init.params)), []
    state, jax_losses = init, []
    for b in batches:
        state, m = jt.step_fn(state, b)
        jax_losses.append(float(m["loss"]))
    for b in batches:
        ps, m = pt.step(ps, b)
        losses.append(float(m["loss"]))
    assert ps.step == int(state.step) == N_STEPS
    np.testing.assert_allclose(losses, jax_losses, rtol=0,
                               atol=1e-4 if dtype == "float32" else 1e-3)
    assert losses[-1] < losses[0]
    want, got = _flatten(_np_tree(state.params)), _flatten(
        pt.params_tree(ps.params))
    if dtype == "float32":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    # the unreached leaves move by the weight decay alone, on both sides
    # (the bias starts at zero and stays there)
    for k in UNUSED:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7)
    moved = not np.array_equal(got[UNUSED[0]], first[UNUSED[0]])
    assert moved == bool(train.get("weight_decay"))


@pytest.mark.parametrize("train", [
    {},
    {"weight_decay": 1e-2, "lr_decay_steps": 3, "lr_decay_rate": 0.5},
    {"grad_clip_norm": 1.0, "learning_rate": 1e-2},
])
def test_optimizer_is_the_optax_chain(train):
    """Trainer._apply against the JAX Trainer's optax chain on the same
    gradients, 6 updates, gradient norms about 0.3 and 30 in turns (so a
    clip of 1 or 10 is active on every other step)."""
    cfg, jt, pt = _setup("laplace", 0, "float32", **train)
    init = jt.init_state()
    params, opt_state = init.params, jt.tx.init(init.params)
    update = jax.jit(jt.tx.update)
    ps = pt.init_state(tree=_np_tree(init.params))
    rng = np.random.default_rng(0)
    for i in range(6):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32), _np_tree(params))
        scale = (0.3 if i % 2 else 30.0) / np.sqrt(sum(
            float((v ** 2).sum()) for v in jax.tree.leaves(g)))
        g = jax.tree.map(lambda v: (v * scale).astype(np.float32), g)
        updates, opt_state = update(
            jax.tree.map(jnp.asarray, g), opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        ps, norm = pt._apply(ps, pt.flat_params(g))
        np.testing.assert_allclose(float(norm), 0.3 if i % 2 else 30.0,
                                   rtol=1e-5)
        want, got = _flatten(_np_tree(params)), _flatten(
            pt.params_tree(ps.params))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    assert ps.step == 6


def test_learning_rate_is_exponential_decay():
    import optax

    cfg, _, pt = _setup("laplace", 0, "float32", learning_rate=1e-3,
                        lr_decay_steps=7, lr_decay_rate=0.3)
    sched = optax.exponential_decay(1e-3, transition_steps=7,
                                    decay_rate=0.3)
    for count in (0, 1, 6, 7, 8, 50):
        assert pt.learning_rate(count) == pytest.approx(
            float(sched(count)), rel=1e-6)


@pytest.mark.parametrize("with_mask", [False, True])
def test_losses_match_jax_heads(with_mask):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 16)).astype(np.float32)
    ids = rng.integers(0, 16, (2, 9)).astype(np.int32)
    out = rng.standard_normal((2, 9, 2)).astype(np.float32) * 3
    target = rng.uniform(-1, 1, (2, 9)).astype(np.float32)
    mask = (np.arange(9) >= 4).astype(np.float32)[None, :] if with_mask \
        else None
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    np.testing.assert_allclose(
        float(heads.softmax_loss(torch.from_numpy(logits),
                                 torch.from_numpy(ids), tm)),
        float(jax_heads.softmax_loss(logits, ids, jm)), rtol=1e-6)
    np.testing.assert_allclose(
        float(heads.laplace_loss(torch.from_numpy(out),
                                 torch.from_numpy(target), -2.0, 1.0, tm)),
        float(jax_heads.laplace_loss(out, target, -2.0, 1.0, jm)),
        rtol=1e-6)


def test_samplers_on_a_generator():
    """The key-based samplers take an explicit generator: the same seed
    draws the same samples; the draws follow the head's distribution."""
    out = torch.zeros(20000, 2)
    out[:, 0] = 0.25
    a = heads.sample_laplace(out, torch.Generator().manual_seed(1))
    b = heads.sample_laplace(out, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (20000,)
    assert abs(float(a.median()) - 0.25) < 0.05       # Laplace(0.25, 1)
    assert abs(float((a - 0.25).abs().mean()) - 1.0) < 0.05
    logits = torch.log(torch.tensor([0.7, 0.2, 0.1])).expand(4, 5000, 3)
    ids = heads.sample_softmax(logits, torch.Generator().manual_seed(2))
    assert ids.dtype == torch.int32 and ids.shape == (4, 5000)
    freq = torch.bincount(ids.reshape(-1).long(), minlength=3) / ids.numel()
    np.testing.assert_allclose(freq.numpy(), [0.7, 0.2, 0.1], atol=0.02)
