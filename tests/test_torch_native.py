"""The port's ctypes bindings over the repo's native C++ (utils/native.py):
they build into the port's own build directory and leave native/ as it
is; each equals the JAX package's binding to the bit (the same C++); and
each meets the port's plain torch function at the JAX suite's tolerances
(tests/test_mlsa_native.py, tests/test_native_featext.py): mc2b at rtol
1e-5 / atol 1e-7, the MLSA filter at atol 2e-6 and its roundtrip below
the 16-bit floor (3e-5), mcep (with and without the F0 lifter) and band
aperiodicity at atol 1e-4, F0 with at most 2% of frames flipping voicing
and rtol 1e-4 on frames both call voiced (the native side runs in double
precision), the world feature matrix at atol 2e-4 on frames whose voicing
agrees."""

import hashlib

import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.data.synthetic import synth_utterance
from shallow_wavenet_tpu.utils import native as jax_native
from shallow_wavenet_tpu_torch.ops import f0, mcep, mlsa
from shallow_wavenet_tpu_torch.utils import native

SR, HOP = 16000, 80
ALPHA = 0.466


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


@pytest.fixture(scope="module")
def wav():
    """A harmonic sweep with an unvoiced noise head (the JAX suite's)."""
    rng = np.random.default_rng(0)
    tt = np.arange(SR) / SR
    track = 150 + 40 * np.sin(2 * np.pi * 0.7 * tt)
    phase = np.cumsum(2 * np.pi * track / SR)
    x = sum((0.4 / k) * np.sin(k * phase) for k in range(1, 5))
    x += 0.01 * rng.standard_normal(x.size)
    head = int(0.2 * SR)
    x[:head] = 0.01 * rng.standard_normal(head)
    return (x / np.abs(x).max() * 0.8).astype(np.float32)


def _coeffs(seed, order=24):
    rng = np.random.default_rng(seed)
    c = np.zeros(order + 1)
    c[1:] = rng.standard_normal(order) * 0.25 / np.arange(1, order + 1)
    return c


def _tree(root):
    """Every file under root with its hash, but the JAX build's lock."""
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.name != ".build.lock"}


def test_builds_into_the_port_and_leaves_native_alone(tmp_path, monkeypatch):
    src = native.SOURCES[0].parent
    # the JAX package's own build writes native/libswt_native.so: have it
    # up to date first, so that a JAX test elsewhere cannot change the tree
    jax_native.load_native()
    before = _tree(src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    lib = native.load_native()
    built = native.lib_path()
    assert built.parent == tmp_path / "build" and built.exists()
    assert built.name.startswith("libswt_native_")
    assert lib.swt_mlsa_filter is not None
    assert _tree(src) == before
    # the default place is the port's own build directory (gitignored)
    monkeypatch.undo()
    assert native.BUILD_DIR == (native.SOURCES[0].parent.parent
                                / "shallow_wavenet_tpu_torch" / "build")
    assert native.native_available()


def test_mlsa_bindings_equal_jax_and_meet_the_plain_recursion():
    c = _coeffs(1)
    b = native.mc2b_native(c, ALPHA)
    assert np.array_equal(b, jax_native.mc2b_native(c, ALPHA))
    np.testing.assert_allclose(b, mlsa.mc2b(t(c), ALPHA).numpy(),
                               rtol=1e-5, atol=1e-7)
    x = synth_utterance(2, SR, 0.1)
    for inverse in (False, True):
        y = native.mlsa_filter_native(x, b, ALPHA, 5, inverse)
        assert np.array_equal(y, jax_native.mlsa_filter_native(
            x, b, ALPHA, 5, inverse))
        plain = mlsa.mlsa_filter(t(x), t(b), ALPHA, 5, inverse).numpy()
        np.testing.assert_allclose(y, plain, atol=2e-6)
    back = native.mlsa_filter_native(
        native.mlsa_filter_native(x, b, ALPHA, 5, False), b, ALPHA, 5, True)
    assert np.abs(back - x).max() < 3e-5


def test_f0_binding(wav):
    f0_n, vuv_n = native.f0_native(wav, SR, HOP)
    j = jax_native.f0_native(wav, SR, HOP)
    assert np.array_equal(f0_n, j[0]) and np.array_equal(vuv_n, j[1])
    f0_t, vuv_t = (a.numpy() for a in f0.estimate_f0(t(wav), SR, HOP))
    assert f0_n.shape == f0_t.shape
    assert np.mean(vuv_t != vuv_n) < 0.02
    both = (vuv_t > 0) & (vuv_n > 0)
    assert both.sum() > 50
    np.testing.assert_allclose(f0_n[both], f0_t[both], rtol=1e-4)


@pytest.mark.parametrize("smoothed", [False, True])
def test_mcep_binding(wav, smoothed):
    args = (1024, HOP, 1024, 24, 0.455)
    kw = {}
    if smoothed:
        f0_n, vuv_n = native.f0_native(wav, SR, HOP)
        kw = dict(f0=(f0_n * vuv_n).astype(np.float32), sample_rate=SR)
    mc_n = native.mcep_native(wav, *args, **kw)
    assert np.array_equal(mc_n, jax_native.mcep_native(wav, *args, **kw))
    tkw = dict(f0_hz=kw["f0"], sample_rate=SR) if smoothed else {}
    mc_t = mcep.mcep_analysis(t(wav), *args, **tkw).numpy()
    assert mc_n.shape == mc_t.shape
    np.testing.assert_allclose(mc_n, mc_t, atol=1e-4)
    with pytest.raises(ValueError, match="power-of-two"):
        native.mcep_native(wav, 1000, HOP, 1000, 24, 0.455)


@pytest.mark.parametrize("win_length", [0, 400])
def test_band_aperiodicity_binding(wav, win_length):
    f0_n, _ = native.f0_native(wav, SR, HOP)
    ap = native.band_aperiodicity_native(wav, f0_n, SR, HOP, win_length, 4)
    assert np.array_equal(ap, jax_native.band_aperiodicity_native(
        wav, f0_n, SR, HOP, win_length, 4))
    ap_t = f0.band_aperiodicity(t(wav), t(f0_n), SR, HOP, win_length,
                                4).numpy()
    k = min(ap.shape[0], ap_t.shape[0])
    np.testing.assert_allclose(ap[:k], ap_t[:k], atol=1e-4)


def test_world_features_binding(wav, tmp_path):
    from shallow_wavenet_tpu.config import get_config as jax_config
    from shallow_wavenet_tpu_torch.bin.feature_extract import extract_one
    from shallow_wavenet_tpu_torch.config import get_config
    from shallow_wavenet_tpu_torch.data.audio_io import write_wav

    over = ["data.feature_type=world", f"data.sample_rate={SR}",
            "data.highpass_cutoff=0"]
    cfg = get_config("shallow_laplace_ns", over)
    feats = native.world_features_native(wav, cfg)
    assert np.array_equal(feats, jax_native.world_features_native(
        wav, jax_config("shallow_laplace_ns", over)))
    wp = tmp_path / "utt.wav"
    write_wav(wp, wav, SR)
    pooled = extract_one(str(wp), cfg, numpy_only=True)
    torch_path = extract_one(str(wp), cfg, device="cpu")
    assert pooled.shape == torch_path.shape
    agree = pooled[:, 1] == torch_path[:, 1]
    assert np.mean(~agree) < 0.02
    np.testing.assert_allclose(pooled[agree], torch_path[agree], atol=2e-4)
