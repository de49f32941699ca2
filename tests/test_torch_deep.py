"""The deep preset (BASELINE config 5, deep_baseline: 30 layers, R=128,
G=256, S=256, aux 32) in the port on the CPU, against the JAX package;
and the decode's choice of kernel layout.

Tolerances: atol 1e-5 as in test_torch_model (fp32 compute, sums in another
order) and test_torch_generate.
"""

import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.bin.decode import decode_batch as jax_decode_batch
from shallow_wavenet_tpu.config import get_config as jax_get_config
from shallow_wavenet_tpu.data.dataset import Utterance as JaxUtterance
from shallow_wavenet_tpu.models import WaveNet as FlaxWaveNet
from shallow_wavenet_tpu.models import extract_plain_params as flax_plain
from shallow_wavenet_tpu.training import Trainer
from shallow_wavenet_tpu_torch.bin import common, decode
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.data.dataset import Utterance
from shallow_wavenet_tpu_torch.models.wavenet import extract_plain_params
from shallow_wavenet_tpu_torch.ops import ar_kernel

from tests.test_model import make_inputs, randomize_head, tiny_cfg
from tests.test_torch_decode import _cfg, _feats, _port_model, _state
from tests.test_torch_generate import assert_same_samples
from tests.test_torch_model import _t, port_model


def _deep():
    # fp32 compute, as tests/test_deep.py runs it on the CPU
    return dataclasses.replace(jax_get_config("deep_baseline").model,
                               compute_dtype="float32")


def test_deep_forward_upsample_and_params_match_flax():
    cfg = _deep()
    m = FlaxWaveNet(cfg)
    x, c, _ = make_inputs(cfg, B=1, F=2, seed=0)
    v = randomize_head(m.init(jax.random.key(0), x, c))
    pm = port_model(cfg, v)
    with torch.no_grad():
        got = pm(_t(x), _t(c)).numpy()
        c_up = pm.upsample_cond(_t(c)).numpy()
    np.testing.assert_allclose(got, np.asarray(m.apply(v, x, c)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        c_up, np.asarray(m.apply(v, c, method="upsample_cond")),
        atol=1e-5, rtol=0)
    want = flax_plain(v, cfg)
    pp = extract_plain_params(pm)
    assert set(pp) == set(want)
    for k in want:
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(want[k]))


def test_deep_preset_resolves_with_world_features():
    """aux_channels = 32 is the world feature dimensionality with the
    energy channel, so the CLI's config check admits the preset."""
    args = argparse.Namespace(config=None, preset="deep_baseline",
                              overrides=[])
    cfg = common.resolve_config(args)
    assert cfg.data.feature_type == "world"
    assert cfg.model.aux_channels == 32
    assert ar_kernel.warmup_length(cfg.model, 64) == 3072


def test_decode_batch_stack8_plain_matches_jax():
    """Decode parity on the plain path at a stack-8 config (top dilation
    128, the widths of the streamed splits): the port's decode_batch on the
    CPU (plain version, fp32; where the rings live changes nothing there)
    against the JAX scan path. The streamed kernel itself is held against
    the resident one on the card (chip_smoke.py)."""
    cfg = _cfg("laplace")
    cfg.model = tiny_cfg(head="laplace", n_stacks=2, stack_size=8)
    state = _state(cfg)
    feats = _feats(cfg, (30, 21), seed=2)
    key = jax.random.key(4)
    want = jax_decode_batch(Trainer(cfg), state, cfg,
                            [JaxUtterance(np.zeros(0), f) for f in feats],
                            key, use_pallas=False)
    T = 30 * cfg.data.hop_length
    noise = np.array(jax.random.uniform(key, (2, T), minval=1e-7,
                                        maxval=1.0 - 1e-7))
    pcfg, model = _port_model(cfg, state)
    assert ar_kernel.stream_split(pcfg.model.dilations, 64, True)[1]
    got = decode.decode_batch(model, pcfg,
                              [Utterance(np.zeros(0), f) for f in feats],
                              noise=torch.from_numpy(noise), device="cpu",
                              layout=decode.kernel_layout(pcfg.model,
                                                          "float32", "cpu"))
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert_same_samples(cfg.model, g, w)


def test_kernel_layout_order_and_refusal(monkeypatch):
    """On the CPU: the first layout of the dtype (the cluster kernel's).
    On a card where no cluster size fits: the first of ar_generate's in the
    JAX tier order whose shared memory fits, skipping streamed layouts that
    stream nothing; ValueError when none fits. The sizes here are a
    stand-in for the kernels' own layout functions."""
    deep = get_config("deep_baseline").model
    assert decode.kernel_layout(deep, "auto", "cpu") == {
        "dtype": "float32", "stream": False, "chunk": 64, "fused": 0,
        "cluster": 16}
    assert decode.kernel_layout(deep, "bfloat16", "cpu")["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="kernel dtype"):
        decode.kernel_layout(deep, "float16", "cpu")

    asked = []

    def fake_bytes(cfg, dtype, stream, chunk, fused):
        asked.append((dtype, stream, chunk))
        assert fused == 0
        return {("float32", True, 32): 1000, ("bfloat16", True, 64): 1500}.get(
            (dtype, stream, chunk), 10**6)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ar_kernel, "smem_limit", lambda dev: 2000)
    monkeypatch.setattr(ar_kernel, "smem_bytes", fake_bytes)
    # no cluster size fits, the wide form's neither
    monkeypatch.setattr(ar_kernel, "cluster_size",
                        lambda cfg, dtype, dev, fused=0, wide=False: 0)
    assert decode.kernel_layout(deep) == {"dtype": "float32", "stream": True,
                                          "chunk": 32, "fused": 0,
                                          "cluster": 0}
    assert asked == [("float32", False, 64), ("float32", True, 64),
                     ("float32", True, 32)]
    assert decode.kernel_layout(deep, "bfloat16")["chunk"] == 64
    # config 2 (top dilation 32) streams no layer at chunk 32 or 64
    c2 = get_config("shallow_laplace_single").model
    asked.clear()
    with pytest.raises(ValueError, match="no AR kernel layout"):
        decode.kernel_layout(c2)
    assert asked == [("float32", False, 64), ("bfloat16", False, 64)]
