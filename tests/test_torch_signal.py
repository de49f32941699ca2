"""The port's signal ops against the JAX package's on the CPU: mel-cepstrum
analysis and MCD (ops/mcep.py), the MLSA filter (ops/mlsa.py), F0, voicing
and band aperiodicity (ops/f0.py), the frame log-energy (ops/energy.py)
and the WORLD-equivalent synthesis (ops/synthesis.py). Inputs are made
from seeds with numpy; both sides get the same arrays.

Tolerances (the JAX suite's own where it has one):
- freqt_matrix and frame_log_energy are numpy copies: exact;
- spectrum_to_mcep, mcep_analysis (with and without the F0 lifter) and
  mcep_to_log_spectrum at atol 1e-4 (tests/test_native_featext.py: another
  FFT and matmul order), mcd at rtol 1e-5;
- mc2b at rtol 1e-5, atol 1e-7; mlsa_filter (forward and inverse) and
  mlsa_filter_tv at atol 2e-6 (tests/test_mlsa_native.py);
- estimate_f0: voicing is a threshold and the lag a discrete choice, so
  FFT ulps can flip a frame; at most 2% of frames may disagree on vuv
  (the JAX suite's native limit), F0 at rtol 1e-4 on frames both call
  voiced; band_aperiodicity at atol 1e-4, log_f0 at rtol 1e-6;
- excitation, excitation_multiband and world_synthesis are handed JAX's
  own jax.random.normal draw and held at atol 2e-4
  (tests/test_synthesis.py's band-sum limit); their F0 tracks avoid
  pulse phases that land on an integer, where the two cumsums' last ulp
  would place a pulse one sample apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.data.synthetic import (
    synth_utterance, synth_utterance_speechlike,
)
from shallow_wavenet_tpu.ops import energy as jax_energy
from shallow_wavenet_tpu.ops import f0 as jax_f0
from shallow_wavenet_tpu.ops import mcep as jax_mcep
from shallow_wavenet_tpu.ops import mlsa as jax_mlsa
from shallow_wavenet_tpu.ops import synthesis as jax_synthesis
from shallow_wavenet_tpu_torch.ops import energy, f0, mcep, mlsa, synthesis

SR, HOP = 16000, 80
ALPHA = 0.455


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread: the signals are short, and on a
    host shared with other test workers a thread pool per op costs more
    than it gives (the previous count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def n(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def wav():
    return synth_utterance(2, SR, 0.4)


def test_freqt_matrix_is_the_same_numpy():
    for m1, m2, a in ((8, 60, ALPHA), (128, 24, 0.466), (24, 128, -0.466)):
        assert np.array_equal(mcep.freqt_matrix(m1, m2, a),
                              jax_mcep.freqt_matrix(m1, m2, a))


@pytest.mark.parametrize("lifter", [False, True])
def test_spectrum_to_mcep(lifter):
    rng = np.random.default_rng(0)
    log_mag = rng.standard_normal((7, 257)).astype(np.float32)
    f0n = rng.uniform(0.0, 0.03, 7).astype(np.float32) if lifter else None
    want = jax_mcep.spectrum_to_mcep(
        jnp.asarray(log_mag), 24, ALPHA,
        f0_norm=None if f0n is None else jnp.asarray(f0n))
    got = mcep.spectrum_to_mcep(t(log_mag), 24, ALPHA,
                                f0_norm=None if f0n is None else t(f0n))
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)


@pytest.mark.parametrize("with_f0", [False, True])
def test_mcep_analysis(wav, with_f0):
    args = (512, HOP, 400, 24, ALPHA)
    kw = {}
    if with_f0:
        # a track two frames short of the spectral frames: edge-padded
        rng = np.random.default_rng(1)
        track = rng.uniform(80, 300, 79).astype(np.float32)
        track[::5] = 0.0
        kw = dict(f0_hz=track, sample_rate=SR)
    want = jax_mcep.mcep_analysis(jnp.asarray(wav), *args, **kw)
    got = mcep.mcep_analysis(t(wav), *args, **kw)
    assert got.shape == want.shape == (81, 25)
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)
    if with_f0:
        plain = mcep.mcep_analysis(t(wav), *args)
        assert float(torch.abs(got - plain).max()) > 1e-3


def test_mcep_to_log_spectrum_and_mcd(wav):
    rng = np.random.default_rng(2)
    mc = (rng.standard_normal((12, 25)) * 0.3).astype(np.float32)
    want = jax_mcep.mcep_to_log_spectrum(jnp.asarray(mc), 512, ALPHA)
    got = mcep.mcep_to_log_spectrum(t(mc), 512, ALPHA)
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)
    other = mc + (rng.standard_normal(mc.shape) * 0.05).astype(np.float32)
    for c0 in (True, False):
        want = float(jax_mcep.mcd(jnp.asarray(mc), jnp.asarray(other[:10]),
                                  exclude_c0=c0))
        got = float(mcep.mcd(t(mc), t(other[:10]), exclude_c0=c0))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _coeffs(seed, order=24):
    rng = np.random.default_rng(seed)
    c = np.zeros(order + 1, np.float32)
    c[1:] = rng.standard_normal(order) * 0.25 / np.arange(1, order + 1)
    c[0] = 0.1
    return c


def test_pade_and_mc2b():
    assert mlsa.pade_coefficients(5) == jax_mlsa.pade_coefficients(5)
    c = _coeffs(0)
    want = jax_mlsa.mc2b(jnp.asarray(c), 0.466)
    np.testing.assert_allclose(n(mlsa.mc2b(t(c), 0.466)), n(want),
                               rtol=1e-5, atol=1e-7)
    frames = np.stack([_coeffs(s, 12) for s in range(3)])
    np.testing.assert_allclose(
        n(mlsa.mc2b(t(frames), ALPHA)),
        n(jax_mlsa.mc2b(jnp.asarray(frames), ALPHA)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("inverse", [False, True])
def test_mlsa_filter(inverse):
    b = n(jax_mlsa.mc2b(jnp.asarray(_coeffs(1)), 0.466))
    x = synth_utterance(3, SR, 0.15)
    want = jax_mlsa.mlsa_filter(jnp.asarray(x), jnp.asarray(b), 0.466, 5,
                                inverse)
    got = mlsa.mlsa_filter(t(x), t(b), 0.466, 5, inverse)
    assert got.dtype == torch.float32 and got.shape == (x.size,)
    np.testing.assert_allclose(n(got), n(want), atol=2e-6)


def test_mlsa_filter_tv():
    frames = np.stack([_coeffs(s, 12) for s in range(20)]) * 0.5
    b = n(jax_mlsa.mc2b(jnp.asarray(frames), ALPHA))
    x = np.random.default_rng(4).standard_normal(20 * HOP + 37).astype(
        np.float32) * 0.3
    want = jax_mlsa.mlsa_filter_tv(jnp.asarray(x), jnp.asarray(b), ALPHA, HOP)
    got = mlsa.mlsa_filter_tv(t(x), t(b), ALPHA, HOP)
    np.testing.assert_allclose(n(got), n(want), atol=2e-6)


def _tone(freq, dur=0.5):
    tt = np.arange(int(SR * dur)) / SR
    return (0.5 * np.sin(2 * np.pi * freq * tt)).astype(np.float32)


SIGNALS = {
    "tone110": lambda: _tone(110.0),
    "tone220": lambda: _tone(220.0),
    "tone330": lambda: _tone(330.0),
    "noise": lambda: (np.random.default_rng(0).standard_normal(SR // 2)
                      .astype(np.float32) * 0.3),
    "silence": lambda: np.zeros(SR // 2, np.float32),
    "speechlike": lambda: synth_utterance_speechlike(6, SR, 0.8),
}


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_estimate_f0(name):
    x = SIGNALS[name]()
    f0_j, vuv_j = map(np.asarray, jax_f0.estimate_f0(jnp.asarray(x), SR, HOP))
    f0_t, vuv_t = map(n, f0.estimate_f0(t(x), SR, HOP))
    assert f0_t.shape == f0_j.shape and f0_t.dtype == np.float32
    assert np.mean(vuv_t != vuv_j) < 0.02, np.mean(vuv_t != vuv_j)
    both = (vuv_t > 0) & (vuv_j > 0)
    if name.startswith("tone") or name == "speechlike":
        assert both.sum() > 10
    np.testing.assert_allclose(f0_t[both], f0_j[both], rtol=1e-4)
    assert np.all(f0_t[vuv_t == 0] == 0)


@pytest.mark.parametrize("win_length", [0, 400])
def test_band_aperiodicity(win_length):
    x = synth_utterance_speechlike(7, SR, 0.6)
    f0_j, _ = jax_f0.estimate_f0(jnp.asarray(x), SR, HOP)
    track = np.asarray(f0_j)
    want = jax_f0.band_aperiodicity(jnp.asarray(x), jnp.asarray(track), SR,
                                    HOP, win_length=win_length, n_bands=4)
    got = f0.band_aperiodicity(t(x), t(track), SR, HOP,
                               win_length=win_length, n_bands=4)
    assert got.shape == want.shape
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)
    assert f0.BAP_F0_REFS == jax_f0.BAP_F0_REFS
    for ref in f0.BAP_F0_REFS:
        assert (f0.bap_window_length(24000, ref)
                == jax_f0.bap_window_length(24000, ref))


def test_log_f0():
    rng = np.random.default_rng(5)
    track = rng.uniform(0.5, 400, 50).astype(np.float32)
    vuv = (rng.uniform(size=50) > 0.3).astype(np.float32)
    want = jax_f0.log_f0(jnp.asarray(track), jnp.asarray(vuv))
    got = f0.log_f0(t(track), t(vuv))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6)
    assert np.all(n(got)[vuv == 0] == 0.0)


def test_frame_log_energy_is_the_same_numpy(wav):
    x = wav.copy()
    x[1000:3000] = 0.0
    for frames in (0, 50, 80):
        assert np.array_equal(energy.frame_log_energy(x, HOP, frames),
                              jax_energy.frame_log_energy(x, HOP, frames))
    assert energy.ENERGY_FLOOR == jax_energy.ENERGY_FLOOR


def _tracks(n_frames, seed):
    """An F0 glide with an unvoiced gap and random aperiodicities."""
    rng = np.random.default_rng(seed)
    f0_track = (140.0 + 60.0 * np.sin(np.linspace(0, 3, n_frames))
                + rng.uniform(-3, 3, n_frames)).astype(np.float32)
    vuv = np.ones(n_frames, np.float32)
    vuv[n_frames // 3:n_frames // 3 + 5] = 0.0
    bap = rng.uniform(0, 1, (n_frames, 4)).astype(np.float32)
    return f0_track * vuv, vuv, bap


@pytest.mark.parametrize("t_len", [0, 40 * HOP + 37])
def test_excitation_with_jax_noise(t_len):
    f0_track, vuv, bap = _tracks(40, 8)
    length = t_len or 40 * HOP
    key = jax.random.key(11)
    noise = np.asarray(jax.random.normal(key, (length,), jnp.float32))
    ap = bap.mean(axis=-1)
    want = jax_synthesis.excitation(jnp.asarray(f0_track), jnp.asarray(vuv),
                                    jnp.asarray(ap), key, SR, HOP, t_len)
    got = synthesis.excitation(t(f0_track), t(vuv), t(ap), SR, HOP, t_len,
                               noise=t(noise))
    np.testing.assert_allclose(n(got), n(want), atol=2e-4)
    want = jax_synthesis.excitation_multiband(
        jnp.asarray(f0_track), jnp.asarray(vuv), jnp.asarray(bap), key, SR,
        HOP, t_len)
    got = synthesis.excitation_multiband(t(f0_track), t(vuv), t(bap), SR,
                                         HOP, t_len, noise=t(noise))
    np.testing.assert_allclose(n(got), n(want), atol=2e-4)


def test_excitation_draws_from_a_generator():
    f0_track, vuv, bap = _tracks(10, 9)
    g = [torch.Generator().manual_seed(3) for _ in range(2)]
    a = synthesis.excitation(t(f0_track), t(vuv), t(bap[:, 0]), SR, HOP,
                             generator=g[0])
    b = synthesis.excitation(t(f0_track), t(vuv), t(bap[:, 0]), SR, HOP,
                             generator=g[1])
    assert torch.equal(a, b) and a.shape == (10 * HOP,)
    with pytest.raises(ValueError):
        synthesis.excitation(t(f0_track), t(vuv), t(bap[:, 0]), SR, HOP)


@pytest.mark.parametrize("per_band", [True, False])
def test_world_synthesis_with_jax_noise(per_band):
    f0_track, vuv, bap = _tracks(24, 10)
    order = 12
    mc = np.stack([_coeffs(s, order) for s in range(24)]) * 0.5
    lf0 = np.where(vuv > 0, np.log(np.maximum(f0_track, 1.0)), 0.0)
    energy_col = np.full((24, 1), -3.0, np.float32)
    feats = np.concatenate([lf0[:, None], vuv[:, None], mc, bap, energy_col],
                           axis=-1).astype(np.float32)
    key = jax.random.key(5)
    noise = np.asarray(jax.random.normal(key, (24 * HOP,), jnp.float32))
    want = jax_synthesis.world_synthesis(jnp.asarray(feats), key, SR, HOP,
                                         order, ALPHA, per_band=per_band,
                                         n_bap=4, peak_norm=True)
    got = synthesis.world_synthesis(t(feats), SR, HOP, order, ALPHA,
                                    per_band=per_band, n_bap=4,
                                    peak_norm=True, noise=t(noise))
    np.testing.assert_allclose(n(got), n(want), atol=2e-4)
