"""The port's streaming session (shallow_wavenet_tpu_torch.models.streaming)
on the CPU, where it runs the AR kernel's plain version: against JAX in
interpret mode (same flax weights, same seed, hence the same numpy
uniforms), and against one batch call of its own.

The JAX session's warm-start forces step t with sample t, one step late
(`_generate` and `_warmstarted` take the last M samples as the teacher,
where `generate_segmented` takes the M before the last), so with a head
whose output depends on the input its stream parts from its own batch
call at the first block boundary; its suite does not see this because its
head2 is zero. `test_jax_session_warm_start_is_one_step_late` pins that.
The port forces step t with sample t - 1, so it is held against what the
JAX session is meant to equal: one JAX batch call over the whole
utterance's conditioning with the JAX session's uniforms; and against the
JAX session itself up to its first block boundary.

Tolerances. Against JAX, as in test_torch_generate: Laplace at atol 1e-5
(the two upsamplers and AR paths sum in other orders). Against the port's
own batch call over the session's concatenated conditioning and uniforms:
exact, since the warm-start replays the same steps. The haloed block
upsampling against the whole utterance's: atol 2e-5, the JAX suite's limit
(test_streaming.py), since a library GEMM may sum a window's rows in
another order than the whole utterance's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.models import WaveNet as FlaxWaveNet
from shallow_wavenet_tpu.models import extract_plain_params as jax_plain
from shallow_wavenet_tpu.models.streaming import (
    StreamingSynthesizer as JaxSynthesizer,
)
from shallow_wavenet_tpu.models.streaming import (
    upsampler_halo as jax_halo,
)
from shallow_wavenet_tpu.ops.ar_kernel import generate_pallas
from shallow_wavenet_tpu_torch.models.streaming import (
    StreamingSynthesizer, upsampler_halo,
)
from shallow_wavenet_tpu_torch.models.wavenet import extract_plain_params
from shallow_wavenet_tpu_torch.ops import ar_kernel
from shallow_wavenet_tpu_torch.ops.mulaw import mulaw_quantize

from tests.test_model import randomize_head, tiny_cfg
from tests.test_torch_generate import assert_same_samples
from tests.test_torch_model import port_cfg, port_model


def _setup(head, B=2, F=100, seed=0, **cfg_kw):
    """tests/test_streaming.py's setup_stream with a random head2."""
    cfg = tiny_cfg(head=head, n_stacks=2, stack_size=3, **cfg_kw)
    m = FlaxWaveNet(cfg)
    rng = np.random.default_rng(seed)
    hop = int(np.prod(cfg.upsample_factors))
    x0 = (jnp.asarray(rng.integers(0, 256, (1, 2 * hop - 1)), jnp.int32)
          if head == "softmax" else
          jnp.asarray(rng.uniform(-1, 1, (1, 2 * hop - 1)), jnp.float32))
    c0 = jnp.asarray(rng.standard_normal((1, 2, cfg.aux_channels)),
                     jnp.float32)
    v = randomize_head(m.init(jax.random.key(3), x0, c0))
    frames = rng.standard_normal((B, F, cfg.aux_channels)).astype(np.float32)
    model = port_model(cfg, v)
    return cfg, m, v, model, frames, hop


def _session(cfg, model, hop, B, **kw):
    return StreamingSynthesizer(extract_plain_params(model), model,
                                port_cfg(cfg), hop_length=hop, batch=B,
                                block_frames=32, chunk=64, device="cpu", **kw)


def _run(syn, frames, step):
    F = frames.shape[1]
    pieces = [syn.push(frames[:, s:s + step]) for s in range(0, F, step)]
    return np.concatenate(pieces + [syn.flush()], axis=1)


def test_upsampler_halo_matches_jax():
    for factors in ((4, 4, 4, 5), (2, 5), (10,), (8, 8), (5, 4, 4, 4)):
        assert upsampler_halo(factors) == jax_halo(factors)


def _jax_run(cfg, m, v, frames, hop, seed, fused):
    """The JAX session, ragged 7-frame pushes: (its samples, its uniforms,
    one JAX batch call over the whole utterance with those uniforms)."""
    pp = jax_plain(v, cfg)
    jsyn = JaxSynthesizer(pp, m, v, cfg, hop_length=hop,
                          batch=frames.shape[0], block_frames=32, chunk=64,
                          seed=seed, interpret=True, fused=fused,
                          record_noise=True)
    wav = _run(jsyn, frames, 7)
    noise = jsyn.noise_so_far()
    c_up = m.apply(v, jnp.asarray(frames), method="upsample_cond")
    batch = np.asarray(generate_pallas(pp, cfg, c_up,
                                       noise=jnp.asarray(noise), chunk=64,
                                       interpret=True, fused=fused))
    return wav, noise, batch


@pytest.mark.parametrize("fused", [0, 3])
def test_session_matches_jax(fused):
    cfg, m, v, model, frames, hop = _setup("laplace")
    B, F, _ = frames.shape
    jwav, jnoise, jbatch = _jax_run(cfg, m, v, frames, hop, 7, fused)
    syn = _session(cfg, model, hop, B, seed=7, fused=fused,
                   record_noise=True)
    got = _run(syn, frames, 7)
    assert got.shape == jwav.shape == (B, F * hop)
    assert syn.samples_emitted == F * hop
    np.testing.assert_array_equal(syn.noise_so_far().numpy(), jnoise)
    assert_same_samples(cfg, got, jbatch)
    first = 32 * hop                   # before the first warm-start
    assert_same_samples(cfg, got[:, :first], jwav[:, :first])


def test_jax_session_warm_start_is_one_step_late():
    """Pins the JAX session's fault (see the module docstring): its stream
    meets its batch call up to the first block boundary and parts there,
    while the port's stream equals its batch call (test below)."""
    cfg, m, v, model, frames, hop = _setup("laplace")
    jwav, _, jbatch = _jax_run(cfg, m, v, frames, hop, 7, 0)
    d = np.abs(jwav - jbatch).max(axis=0)
    assert d[:32 * hop].max() == 0.0
    assert d[32 * hop:].max() > 1e-3


@pytest.mark.parametrize("head, fused", [("laplace", 0), ("softmax", 0),
                                         ("laplace", 4)])
def test_stream_equals_one_batch_call(head, fused):
    """Ragged pushes; the samples equal one call over the session's own
    concatenated conditioning and uniforms, exactly, and that conditioning
    equals the whole utterance's upsampling at the upsampler's limit."""
    cfg, m, v, model, frames, hop = _setup(head, F=90)
    B, F, _ = frames.shape
    syn = _session(cfg, model, hop, B, seed=3, fused=fused,
                   record_noise=True)
    wav = _run(syn, frames, 11)
    assert wav.shape == (B, F * hop)
    c_up, noise = syn.cond_so_far(), syn.noise_so_far()
    assert c_up.shape == (B, F * hop, cfg.cond_channels)
    batch = ar_kernel.generate(extract_plain_params(model), syn.cfg, c_up,
                               noise=noise, device="cpu",
                               fused=fused).numpy()
    if head == "softmax":
        # the kernel's output is class ids; the elementwise dequantize
        # outside it may round 1 ulp apart on the CPU between tensors of
        # other lengths (vector body against scalar tail)
        q = cfg.quantize_channels
        wav, batch = (mulaw_quantize(torch.from_numpy(x), q).numpy()
                      for x in (wav, batch))
    np.testing.assert_array_equal(wav, batch)
    with torch.no_grad():
        full = model.upsample_cond(torch.from_numpy(frames))
    torch.testing.assert_close(c_up, full, rtol=0, atol=2e-5)


@pytest.mark.parametrize("head", ["laplace", "softmax"])
def test_block_of_exactly_m_samples(head):
    """A block of exactly M samples (hop 8, 8-frame blocks, M = 64) is
    taken, as the JAX session takes it, and the stream still equals one
    call: the warm-up's M + 1 history samples roll over from the previous
    history and the block."""
    cfg, m, v, model, frames, hop = _setup(head, F=45,
                                           upsample_factors=(2, 4))
    B = frames.shape[0]
    syn = StreamingSynthesizer(extract_plain_params(model), model,
                               port_cfg(cfg), hop_length=hop, batch=B,
                               block_frames=8, chunk=64, device="cpu",
                               seed=5, record_noise=True)
    assert 8 * hop == syn.M == 64
    wav = _run(syn, frames, 3)
    assert wav.shape == (B, 45 * hop)
    batch = ar_kernel.generate(extract_plain_params(model), syn.cfg,
                               syn.cond_so_far(), noise=syn.noise_so_far(),
                               device="cpu").numpy()
    if head == "softmax":
        q = cfg.quantize_channels
        wav, batch = (mulaw_quantize(torch.from_numpy(x), q).numpy()
                      for x in (wav, batch))
    np.testing.assert_array_equal(wav, batch)
    # below M it is refused: dilations 1..16 twice, M = 64 at chunk 32
    deep = port_cfg(tiny_cfg(n_stacks=2, stack_size=5,
                             upsample_factors=(2, 4)))
    with pytest.raises(ValueError, match="warm-start length M=64"):
        StreamingSynthesizer({}, None, deep, hop_length=hop, batch=B,
                             block_frames=4, chunk=32, device="cpu")


def test_session_rejects_bad_shapes_and_closed_use():
    cfg, m, v, model, frames, hop = _setup("laplace", F=10)
    syn = _session(cfg, model, hop, 2)
    with pytest.raises(ValueError):
        syn.push(frames[0])                        # missing batch dim
    with pytest.raises(ValueError):
        syn.push(frames[:, :, :3])                 # wrong aux width
    with pytest.raises(ValueError):
        StreamingSynthesizer({}, model, port_cfg(cfg), hop_length=hop,
                             batch=2, block_frames=3, chunk=64,
                             device="cpu")          # 30 % 64 != 0
    with pytest.raises(RuntimeError):
        syn.noise_so_far()                         # not recorded
    syn.push(frames)
    syn.flush()
    with pytest.raises(RuntimeError):
        syn.push(frames)
    with pytest.raises(RuntimeError):
        syn.flush()
