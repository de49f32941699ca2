"""The AR kernel's fused window (shallow_wavenet_tpu_torch.ops.ar_kernel with
fused=W) against the JAX `generate_pallas(..., fused=W)` in interpret mode on
the CPU, where the port runs its plain version: same plain params,
conditioning, uniforms and teacher.

Tolerances, as in test_torch_generate: Laplace at atol 1e-5 (the fused sums
run in another order than the unfused ones, and the port's in another order
than JAX's), softmax class ids within 1 bin on under 1% of samples. Where
the rings live does not change the arithmetic, and segmentation replays the
same steps, so both are held exactly against the port's own unsegmented,
resident call. bf16: both sides round to bf16 at the same points (the
fused weights too) and sum exact products in fp32, so they meet at 1e-5; the
port at fp32 on the same inputs, the control, must miss by 10x that.
`fused_weights` (its packed projections split per layer) is held at 1e-6
against the JAX wrapper's construction with its lane padding stripped (fp32
matmuls of the same operands).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.ops import ar_kernel as jax_ar
from shallow_wavenet_tpu.ops.ar_kernel import generate_pallas
from shallow_wavenet_tpu_torch.bin import kfuse
from shallow_wavenet_tpu_torch.models.generate import generate_segmented
from shallow_wavenet_tpu_torch.ops import ar_kernel

from tests.test_torch_generate import _gen, _noise, _port, assert_same_samples
from tests.test_torch_model import port_cfg, port_pp
from tests.test_torch_stream_bf16 import _big_dil, _teacher


def _pallas(pp, cfg, c_up, noise, **kw):
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    return np.asarray(generate_pallas(pp, cfg, jnp.asarray(c_up),
                                      noise=jnp.asarray(noise), chunk=64,
                                      interpret=True, **kw))


@pytest.mark.parametrize("head", ["laplace", "softmax"])
@pytest.mark.parametrize("fused", [2, 3, 5])
def test_fused_sample_matches_pallas_interpret(head, fused):
    cfg, m, v, pp, c_up = _gen(head, F=6)
    B, T, _ = c_up.shape
    noise = _noise((B, T), 11)
    got = _port(pp, cfg, c_up, noise, fused=fused)
    want = _pallas(pp, cfg, c_up, noise, fused=fused)
    assert_same_samples(cfg, got, want)


@pytest.mark.parametrize("head", ["laplace", "softmax"])
def test_fused_teacher_forced_matches_pallas_interpret(head):
    cfg, m, v, pp, c_up = _gen(head, F=6)
    B, T, _ = c_up.shape
    noise = _noise((B, T), 4)
    teacher = _teacher(head, (B, T), 5)
    got = _port(pp, cfg, c_up, noise, fused=3,
                teacher=torch.from_numpy(teacher))
    want = _pallas(pp, cfg, c_up, noise, fused=3, teacher=teacher)
    assert_same_samples(cfg, got, want)


def test_fused_streamed_matches_pallas_interpret_and_resident():
    cfg, pp, c_up = _big_dil("laplace")
    assert jax_ar._stream_split(cfg.dilations, 64, True)[1]
    B, T, _ = c_up.shape
    noise = _noise((B, T), 5)
    got = _port(pp, cfg, c_up, noise, stream=True, chunk=64, fused=3)
    want = _pallas(pp, cfg, c_up, noise, stream=True, fused=3)
    assert_same_samples(cfg, got, want)
    np.testing.assert_array_equal(got, _port(pp, cfg, c_up, noise, fused=3))


def test_fused_segmented_equals_unsegmented():
    cfg, m, v, pp, c_up = _gen("laplace", F=30)          # T = 299
    pcfg, ppp = port_cfg(cfg), port_pp(pp)
    B, T, _ = c_up.shape
    c_t, n_t = torch.from_numpy(c_up), torch.from_numpy(_noise((B, T), 21))
    layout = ar_kernel.Layout(fused=4)
    seg = generate_segmented(ppp, pcfg, c_t, n_t, 128, device="cpu",
                             layout=layout)
    full = ar_kernel.generate(ppp, pcfg, c_t, noise=n_t, device="cpu",
                              layout=layout)
    torch.testing.assert_close(seg, full, rtol=0, atol=0)


@pytest.mark.parametrize("chain", [False, True])
def test_fused_bf16_teacher_forced_matches_pallas_interpret(chain):
    """`chain` sums every dot and gate input in the kernel's order; it is
    held at the same limit (only the order of fp32 sums differs)."""
    cfg, m, v, pp, c_up = _gen("laplace", F=6, seed=1)
    B, T, _ = c_up.shape
    noise = _noise((B, T), 3)
    teacher = _teacher("laplace", (B, T), 4)
    want = _pallas(pp, cfg, c_up, noise, teacher=teacher, fused=3,
                   dtype="bfloat16")
    kw = dict(noise=torch.from_numpy(noise), teacher=torch.from_numpy(teacher),
              device="cpu", fused=3)
    got = ar_kernel.generate_plain(port_pp(pp), port_cfg(cfg),
                                   torch.from_numpy(c_up), dtype="bfloat16",
                                   chain=chain, **kw).numpy()
    control = ar_kernel.generate_plain(port_pp(pp), port_cfg(cfg),
                                       torch.from_numpy(c_up), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(control - want).max() > 10 * 1e-5


def test_kernel_weights_made_once_give_the_same_samples():
    """Weights made once (`kernel_weights`) give the samples of a call on
    plain params in their layout; weights of another dtype or window are
    refused."""
    cfg, m, v, pp, c_up = _gen("laplace", F=6)
    pcfg, ppp = port_cfg(cfg), port_pp(pp)
    B, T, _ = c_up.shape
    kw = dict(noise=torch.from_numpy(_noise((B, T), 8)), device="cpu")
    c_t = torch.from_numpy(c_up)
    Layout = ar_kernel.Layout
    w = ar_kernel.kernel_weights(ppp, pcfg, Layout(fused=3), "cpu")
    assert ar_kernel.kernel_weights(w, pcfg) is w
    torch.testing.assert_close(
        ar_kernel.generate(w, pcfg, c_t, **kw),
        ar_kernel.generate(ppp, pcfg, c_t, layout=Layout(fused=3), **kw),
        rtol=0, atol=0)
    for other in (Layout(fused=2), Layout("bfloat16", 3)):
        with pytest.raises(ValueError, match="kernel weights"):
            ar_kernel.generate(w, pcfg, c_t, layout=other, **kw)


def _jax_fused_weights(pp, cfg, fused):
    """The JAX wrapper's fused weights (ar_kernel.py:655-737), padded."""
    G, R, S = cfg.gate_channels, cfg.residual_channels, cfg.skip_channels
    half = G // 2
    gp = jax_ar._gate_pad(half)
    sp, rp = jax_ar._skip_pad(S), jax_ar._res_pad(R)

    def pad_gate_cols(w):
        out = jnp.zeros(w.shape[:-1] + (2 * gp,), w.dtype)
        out = out.at[..., :half].set(w[..., :half])
        return out.at[..., gp:gp + half].set(w[..., half:])

    conv_w = pad_gate_cols(jnp.asarray(pp["conv_w"]))
    conv_b_f = pad_gate_cols(jnp.asarray(pp["conv_b"]))
    pad_rows = ((0, 0), (0, gp - half), (0, 0))
    res_w = jnp.pad(jnp.asarray(pp["res_w"]), pad_rows)
    skip_w = jnp.pad(jnp.asarray(pp["skip_w"]), pad_rows)
    w1cats, fms = [], []
    for blk in jax_ar._fused_blocks(len(cfg.dilations), fused):
        w1cats.append(jnp.concatenate([conv_w[l, 1] for l in blk], axis=-1))
        for k, l in enumerate(blk):
            rem = len(blk) - 1 - k
            parts = jnp.zeros((gp, sp + rp + rem * 2 * gp), jnp.float32)
            parts = parts.at[:, :S].set(skip_w[l])
            parts = parts.at[:, sp:sp + R].set(res_w[l])
            for mq in range(rem):
                m = blk[k + 1 + mq]
                parts = parts.at[:, sp + rp + mq * 2 * gp:
                                 sp + rp + (mq + 1) * 2 * gp].set(
                    jnp.dot(res_w[l], conv_w[m, 1]))
                conv_b_f = conv_b_f.at[m].add(
                    jnp.dot(jnp.asarray(pp["res_b"][l]), conv_w[m, 1]))
            fms.append(parts)
    return gp, sp, rp, w1cats, fms, conv_b_f


@pytest.mark.parametrize("fused", [2, 4])
def test_fused_weights_match_jax_construction(fused):
    cfg, m, v, pp, c_up = _gen("laplace")
    G, R, S = cfg.gate_channels, cfg.residual_channels, cfg.skip_channels
    half = G // 2
    gp, sp, rp, w1cats, fms, conv_b = _jax_fused_weights(pp, cfg, fused)
    got = ar_kernel.fused_weights(port_pp(pp), port_cfg(cfg), fused)

    def gate(x):                       # strip the gate-half padding
        return np.concatenate([x[..., :half], x[..., gp:gp + half]], -1)

    close = dict(atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["conv_b"].numpy(),
                               gate(np.asarray(conv_b)), **close)
    # the block input's weights: the kernel reads its layers' tap-1 weights
    # from conv_w, side by side as JAX's w1cat holds them
    conv_w = port_pp(pp)["conv_w"]
    blocks = ar_kernel.fused_blocks(len(cfg.dilations), fused)
    assert len(blocks) == len(w1cats)
    for blk, theirs in zip(blocks, w1cats):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(
            np.concatenate([np.asarray(conv_w[l, 1]) for l in blk], -1),
            np.concatenate([gate(theirs[:, k * 2 * gp:(k + 1) * 2 * gp])
                            for k in range(len(blk))], -1), **close)
    layers = ar_kernel.fm_layers(got["fm"], port_cfg(cfg), fused)
    assert got["fm"].ndim == 1
    assert sum(x.numel() for x in layers) == got["fm"].numel()
    assert len(layers) == len(fms) == len(cfg.dilations)
    for ours, theirs in zip(layers, fms):
        theirs = np.asarray(theirs)[:half]
        rem = (theirs.shape[1] - sp - rp) // (2 * gp)
        want = [theirs[:, :S], theirs[:, sp:sp + R]] + [
            gate(theirs[:, sp + rp + q * 2 * gp:sp + rp + (q + 1) * 2 * gp])
            for q in range(rem)]
        np.testing.assert_allclose(ours.numpy(), np.concatenate(want, -1),
                                   **close)
    assert ar_kernel.fused_blocks(7, 3) == jax_ar._fused_blocks(7, 3)


@pytest.mark.parametrize("kw, error", [
    (dict(steps=100), ValueError),           # not whole prototype chunks
    (dict(device="cpu"), RuntimeError),      # it times the CUDA kernel
])
def test_kfuse_sweep_refuses_before_any_launch(kw, error):
    with pytest.raises(error):
        kfuse.sweep(**kw)
