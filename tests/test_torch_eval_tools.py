"""The decode's pitch transposition, profiling and fused ladder, and the
three evaluation tools (bin/pitch_eval.py, bin/as_oracle.py,
bin/fused_ab.py), on the CPU against the JAX decode and tools/.

- `shift_f0` equals the JAX decode's to the bit, on tests/test_eval.py's
  case and a random one, with the same refusals;
- `decode --f0-factor F` writes the wavs of a decode of the features that
  `shift_f0` moved, and `decode --profile` the same wavs and one trace;
- where no layout fits the fused window, the decode drops --fused with a
  warning and decodes unfused (the summary records fused 0), and raises
  where no unfused layout fits either;
- pitch_eval's `median_f0` and `frame_ratio` against the JAX tool's on
  the same signal: F0 within rtol 1e-4 (tests/test_torch_signal.py's F0
  limit), so the medians within 1e-4 relative and the common frames
  within 2% of the frames (its voicing limit); its rows (main's JSON)
  against the JAX tool's, fed JAX's own noise draw: the per-frame ratio
  within 1e-3 relative, the MCD against the transposed oracle within 0.05
  dB (the world features meet JAX's at 2e-4 on frames whose voicing
  agrees, and the oracle sums the whole utterance); the oracle's own
  per-frame ratio within 5% of the factor on smoothed features;
- as_oracle's rows against the JAX tool's `eval_pair` results (captured),
  fed JAX's draw: MCD and LSD within 1e-3 dB, the F0 RMSE within 1e-3
  relative, V/UV within 0.02 (tests/test_torch_recipe.py's eval limits);
- fused_ab on a tiny CPU workdir: its unfused decode is the recipe's
  stage-5 decode byte for byte, and both MCDs are finite.
"""

import io
import json
import logging
import shutil
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.bin import decode as jax_decode
from shallow_wavenet_tpu.bin import mcd_eval as jax_mcd_eval
from shallow_wavenet_tpu.bin.common import Utterance as JaxUtterance
from shallow_wavenet_tpu.config import get_config as jax_config
from shallow_wavenet_tpu_torch.bin import (
    as_oracle, decode, feature_extract, fused_ab, pitch_eval,
)
from shallow_wavenet_tpu_torch.bin import run as run_cli
from shallow_wavenet_tpu_torch.bin.common import load_utterances
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.data.audio_io import read_wav
from shallow_wavenet_tpu_torch.data.dataset import Utterance
from shallow_wavenet_tpu_torch.data.hdf5_io import write_hdf5
from shallow_wavenet_tpu_torch.data.synthetic import make_corpus
from shallow_wavenet_tpu_torch.models.wavenet import (
    WaveNet, init_params_tree, load_params_npz, params_from_flax,
    save_params_npz,
)
from shallow_wavenet_tpu_torch.ops import ar_kernel

from tests.test_torch_recipe import NS, TINY, WORLD
from tools import as_oracle as jax_as_oracle
from tools import pitch_eval as jax_pitch_eval

SR = 8000


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread (tests/test_torch_recipe.py's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_noise(n: int) -> np.ndarray:
    """The JAX tools' excitation noise: jax.random.key(0)'s normal draw."""
    return np.array(jax.random.normal(jax.random.key(0), (n,),
                                       jnp.float32))


# ---- shift_f0 ---------------------------------------------------------------

def _stats(tmp_path, dim, seed):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(dim).astype(np.float32)
    std = rng.uniform(0.5, 2.0, dim).astype(np.float32)
    write_hdf5(tmp_path / "stats.h5", "mean", mean)
    write_hdf5(tmp_path / "stats.h5", "std", std)
    return mean, std


def _raw_cases(rng, dim):
    """tests/test_eval.py's case (voiced first half at log 150 Hz,
    unvoiced second) and a random one (voicing drawn per frame)."""
    a = rng.standard_normal((10, dim)).astype(np.float32)
    a[:5, 0], a[:5, 1] = np.log(150.0), 1.0
    a[5:, 0], a[5:, 1] = 0.0, 0.0
    b = rng.standard_normal((37, dim)).astype(np.float32)
    vuv = rng.random(37) < 0.6
    b[:, 1] = vuv
    b[:, 0] = np.where(vuv, np.log(rng.uniform(80, 300, 37)), 0.0)
    return a, b


@pytest.mark.parametrize("factor", [1.5, 0.7])
def test_shift_f0_is_jax_to_the_bit(tmp_path, factor):
    over = ["data.feature_type=world", "model.aux_channels=31"]
    cfg, jcfg = (get_config("shallow_laplace_ns", over),
                 jax_config("shallow_laplace_ns", over))
    mean, std = _stats(tmp_path, 31, 0)
    for raw in _raw_cases(np.random.default_rng(1), 31):
        norm = (raw - mean) / np.maximum(std, 1e-8)
        (got,) = decode.shift_f0([Utterance(np.zeros(0), norm.copy())], cfg,
                                 tmp_path / "stats.h5", factor)
        (want,) = jax_decode.shift_f0(
            [JaxUtterance(np.zeros(0), norm.copy())], jcfg,
            tmp_path / "stats.h5", factor)
        assert np.array_equal(got.feats, want.feats)
        lf0 = got.feats[:, 0] * max(std[0], 1e-8) + mean[0]
        voiced = raw[:, 1] > 0.5
        np.testing.assert_allclose(lf0[voiced], raw[voiced, 0]
                                   + np.log(factor), rtol=1e-5)
        np.testing.assert_allclose(lf0[~voiced], 0.0, atol=1e-5)
        assert np.array_equal(got.feats[:, 1:], norm[:, 1:])
    mel, jmel = (get_config("shallow_laplace_ns"),
                 jax_config("shallow_laplace_ns"))
    for fn, c, f in ((decode.shift_f0, mel, 1.2), (decode.shift_f0, cfg, 0),
                     (jax_decode.shift_f0, jmel, 1.2),
                     (jax_decode.shift_f0, jcfg, 0)):
        with pytest.raises(ValueError, match="feature_type=world|> 0"):
            fn([], c, tmp_path / "stats.h5", f)


# ---- the decode CLI: --f0-factor, --profile, the fused ladder ---------------

@pytest.fixture
def world_decode(tmp_path):
    """A tiny world-feature model (random weights, head with signal), two
    utterances of normalized features and their stats."""
    cfg = get_config("shallow_laplace_ns", [*TINY, *WORLD])
    (tmp_path / "config.json").write_text(cfg.to_json())
    tree = init_params_tree(cfg.model, 3)
    rng = np.random.default_rng(3)
    tree["head2"]["kernel"] = (0.05 * rng.standard_normal(
        tree["head2"]["kernel"].shape)).astype(np.float32)
    save_params_npz(tmp_path / "params.npz", tree)
    dim = cfg.model.aux_channels
    _stats(tmp_path, dim, 5)
    names = ["spk0_a.wav", "spk0_b.wav"]
    for i, n in enumerate(names):
        raw = _raw_cases(rng, dim)[1][: 5 + 3 * i]
        write_hdf5(tmp_path / "feats" / (n[:-4] + ".h5"), "feats", raw)
    (tmp_path / "eval.scp").write_text(
        "".join(f"{tmp_path / n}\n" for n in names))
    args = ["--config", str(tmp_path / "config.json"), "--eval-scp",
            str(tmp_path / "eval.scp"), "--feats-dir", str(tmp_path / "feats"),
            "--stats", str(tmp_path / "stats.h5"), "--params",
            str(tmp_path / "params.npz"), "--device", "cpu"]
    return cfg, args, names


def _wavs(d, names):
    return [(d / n).read_bytes() for n in names]


def test_decode_f0_factor_and_profile(world_decode, tmp_path):
    cfg, args, names = world_decode
    decode.main(args + ["--outdir", str(tmp_path / "plain")])
    decode.main(args + ["--outdir", str(tmp_path / "up"), "--f0-factor",
                        "1.3"])
    decode.main(args + ["--outdir", str(tmp_path / "prof"), "--profile"])
    # the same decode, on the features shift_f0 moved, through the library
    utts = decode.shift_f0(
        load_utterances(tmp_path / "eval.scp", tmp_path / "feats",
                        tmp_path / "stats.h5", load_wav=False),
        cfg, tmp_path / "stats.h5", 1.3)
    model = params_from_flax(WaveNet(cfg.model),
                             load_params_npz(tmp_path / "params.npz"))
    decode.decode_utterances(model, cfg, utts, names, tmp_path / "lib",
                             torch.Generator().manual_seed(0),
                             device="cpu")
    assert _wavs(tmp_path / "up", names) == _wavs(tmp_path / "lib", names)
    assert _wavs(tmp_path / "up", names) != _wavs(tmp_path / "plain", names)
    assert _wavs(tmp_path / "prof", names) == _wavs(tmp_path / "plain",
                                                    names)
    traces = list((tmp_path / "prof/profile").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    assert not (tmp_path / "plain/profile").exists()
    with pytest.raises(ValueError, match="> 0"):
        decode.main(args + ["--outdir", str(tmp_path / "x"), "--f0-factor",
                            "-1"])


def test_fused_ladder_drops_the_window(monkeypatch, caplog, world_decode,
                                       tmp_path):
    """On a card (sizes and shared memory standing in for the kernels'
    own): no layout fits W = 4, so the decode's layout is the unfused
    cluster one, with a warning; choose_layout itself still raises; with
    no unfused layout either, the decode raises."""
    c2 = get_config("shallow_laplace_single").model
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(ar_kernel, "smem_limit", lambda dev: 2000)
        fits = {0: 1000, 4: 3000}
        m.setattr(ar_kernel, "smem_bytes", lambda cfg, lay: fits[lay.fused])
        sizes = {0: 8, 4: 0}
        # no size of the cluster kernel's wide form fits either
        m.setattr(ar_kernel, "_cluster_layout",
                  lambda cfg, dtype, dev, fused, ns, wide=False:
                  None if wide or not sizes[fused] else
                  ar_kernel.Layout(dtype, fused, sizes[fused]))
        with pytest.raises(ar_kernel.NoLayoutError, match="fused=4"):
            ar_kernel.choose_layout(c2, fused=4)
        with caplog.at_level(logging.WARNING, logger="decode"):
            lay = decode.decode_layout(c2, fused=4)
        assert lay == ar_kernel.Layout(cluster=8)
        assert any("--fused 4 dropped" in r.getMessage()
                   for r in caplog.records)
        assert decode.decode_layout(c2) == lay
        sizes[0], fits[0] = 0, 3000
        with pytest.raises(ar_kernel.NoLayoutError, match="fused=0"):
            decode.decode_layout(c2, fused=4)
        with pytest.raises(ar_kernel.NoLayoutError, match="fused=0"):
            decode.decode_layout(c2)

    # through the decode: a layout that never fits a fused window records
    # the unfused layout that ran, and writes the unfused decode's wavs
    cfg, args, names = world_decode
    real = ar_kernel.choose_layout

    def no_fused(model_cfg, dtype="auto", device=None, fused=0,
                 cluster=True):
        if fused:
            raise ar_kernel.NoLayoutError(f"no layout fits fused={fused}")
        return real(model_cfg, dtype, device, fused, cluster)

    monkeypatch.setattr(ar_kernel, "choose_layout", no_fused)
    decode.main(args + ["--outdir", str(tmp_path / "a"), "--fused", "2"])
    decode.main(args + ["--outdir", str(tmp_path / "b")])
    summary = json.loads((tmp_path / "a/decode_summary.json").read_text())
    assert summary["kernel"]["fused"] == 0
    assert _wavs(tmp_path / "a", names) == _wavs(tmp_path / "b", names)


# ---- pitch_eval -------------------------------------------------------------

@pytest.fixture(scope="module")
def smooth_corpus(tmp_path_factory):
    """One 0.5 s speechlike eval utterance at 8 kHz, world features with
    envelope smoothing (the pitch measurement's setting)."""
    root = tmp_path_factory.mktemp("pitch")
    make_corpus(root, n_train=1, n_eval=1, sample_rate=SR, duration_s=0.5,
                seed=7, style="speechlike")
    over = [*TINY, *WORLD, "data.envelope_smoothing=true"]
    cfg = get_config("shallow_laplace_ns", over)
    (root / "config.json").write_text(cfg.to_json())
    return root, cfg, jax_config("shallow_laplace_ns", over)


def test_median_f0_and_frame_ratio_against_the_tool(smooth_corpus):
    root, cfg, _ = smooth_corpus
    wp = (root / "eval.scp").read_text().split()[0]
    wav, _ = read_wav(wp)
    hop = cfg.data.hop_length
    got = pitch_eval.median_f0(wav, SR, hop, device="cpu")
    want = jax_pitch_eval.median_f0(wav, SR, hop)
    assert got is not None and abs(got - want) <= 1e-4 * want
    feats = feature_extract.extract_one(wp, cfg, device="cpu")
    lf0, vuv = feats[:, 0], feats[:, 1]
    up = np.interp(np.arange(0, len(wav), 1 / 1.25)[: len(wav)],
                   np.arange(len(wav)), wav).astype(np.float32)
    for gen in (wav, up):
        (r, nf), (rj, nfj) = (pitch_eval.frame_ratio(gen, lf0, vuv, SR, hop,
                                                     device="cpu"),
                              jax_pitch_eval.frame_ratio(gen, lf0, vuv, SR,
                                                         hop))
        assert abs(r - rj) <= 1e-4 * rj
        assert abs(nf - nfj) <= 0.02 * len(lf0)
    assert pitch_eval.median_f0(np.zeros(4000, np.float32), SR, hop,
                                device="cpu") is None


def test_pitch_eval_rows_against_the_tool(smooth_corpus, tmp_path,
                                          monkeypatch):
    root, cfg, _ = smooth_corpus
    wp = (root / "eval.scp").read_text().split()[0]
    gen = tmp_path / "gen"
    gen.mkdir()
    shutil.copy(wp, gen)
    pairs = [f"1.3:{gen}"]
    with redirect_stdout(io.StringIO()):
        monkeypatch.setattr("sys.argv", [
            "pitch_eval", "--ref-scp", str(root / "eval.scp"), "--config",
            str(root / "config.json"), "--pair", pairs[0], "--json",
            str(tmp_path / "jax.json")])
        jax_pitch_eval.main()
        got = pitch_eval.evaluate(root / "eval.scp", cfg, [(1.3, gen)],
                                  device="cpu", noise=jax_noise,
                                  log=lambda s: None)
    want = json.loads((tmp_path / "jax.json").read_text())
    (g,), (w,) = got["pairs"][0]["rows"], want["pairs"][0]["rows"]
    assert set(g) == set(w) and g["utt"] == w["utt"]
    assert abs(g["ratio"] - w["ratio"]) <= 1e-3 * w["ratio"]
    assert abs(g["mcd_vs_transposed_oracle"]
               - w["mcd_vs_transposed_oracle"]) <= 0.05
    # the CLI's JSON is evaluate's
    out = pitch_eval.main(["--ref-scp", str(root / "eval.scp"), "--config",
                           str(root / "config.json"), "--pair", pairs[0],
                           "--device", "cpu", "--json",
                           str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        json.dumps(out))


def test_transposed_oracle_moves_the_pitch(smooth_corpus):
    """The measurement chain: on smoothed features the transposed
    oracle's per-frame ratio meets the factor within 5%."""
    root, cfg, _ = smooth_corpus
    wp = (root / "eval.scp").read_text().split()[0]
    feats = feature_extract.extract_one(wp, cfg, device="cpu")
    n = len(read_wav(wp)[0])
    for factor in (0.7, 1.3):
        oracle = pitch_eval.transposed_oracle(feats, cfg, factor, n,
                                              seed=0, device="cpu")
        assert oracle.shape == (n,) and np.abs(oracle).max() <= 1.0
        r, nf = pitch_eval.frame_ratio(oracle, feats[:, 0], feats[:, 1],
                                       SR, cfg.data.hop_length,
                                       device="cpu")
        assert nf >= 3 and abs(r / factor - 1) <= 0.05, (factor, r, nf)


# ---- as_oracle --------------------------------------------------------------

def test_as_oracle_rows_against_the_tool(monkeypatch):
    captured = []
    real = jax_mcd_eval.eval_pair

    def capture(ref, gen, cfg):
        captured.append(real(ref, gen, cfg))
        return captured[-1]

    monkeypatch.setattr(jax_mcd_eval, "eval_pair", capture)
    for k, v in (("N", 1), ("SR", SR), ("CORPUS", "speechlike"),
                 ("SMOOTH", False), ("PER_BAND", False), ("DET", False)):
        monkeypatch.setattr(jax_as_oracle, k, v)
    with redirect_stdout(io.StringIO()):
        jax_as_oracle.main()
    rows = as_oracle.oracle_rows("speechlike", 1, SR, device="cpu",
                                 noise=jax_noise, log=lambda s: None)
    (got,), (want,) = rows, captured
    assert set(got) == set(want)
    for k in ("mcd_db", "lsd_db"):
        assert abs(got[k] - want[k]) <= 1e-3, k
    assert abs(got["f0_rmse_hz"] - want["f0_rmse_hz"]) <= 1e-3 * max(
        want["f0_rmse_hz"], 1.0)
    assert abs(got["vuv_error_rate"] - want["vuv_error_rate"]) <= 0.02
    with pytest.raises(SystemExit):
        as_oracle.main(["--pb", "2"])


def test_as_oracle_det_and_generator(smooth_corpus):
    """det=1 zeroes the voiced aperiodicity; the generator's draw is the
    seed's, so a call repeats itself."""
    root, _, _ = smooth_corpus
    wp = (root / "eval.scp").read_text().split()[0]
    cfg = as_oracle.oracle_config(SR)
    rows = [as_oracle.oracle_row(wp, cfg, det=True, seed=0, device="cpu")
            for _ in range(2)]
    assert rows[0] == rows[1] and np.isfinite(rows[0]["mcd_db"])


# ---- fused_ab ---------------------------------------------------------------

def test_fused_ab_on_a_tiny_workdir(tmp_path):
    src = tmp_path / "wavs"
    make_corpus(src, n_train=2, n_eval=1, sample_rate=SR, duration_s=0.25,
                seed=3)
    wd = tmp_path / "exp"
    run_cli.main(["--preset", "shallow_laplace_ns", "--workdir", str(wd),
                  "--stage", "0", "--stop-stage", "5", "--steps", "2",
                  "--n-eval", "1", "--wav-dir", str(src), "--device", "cpu",
                  *TINY, *NS])
    printed = []
    res = fused_ab.run(wd, fused=2, device="cpu", log=printed.append)
    assert set(res) == {"unfused", "fused2"}
    assert all(np.isfinite(v) for v in res.values())
    assert printed and printed[0].startswith("A/B: unfused")
    (name,) = [p.name for p in (wd / "gen_wav").glob("*.wav")]
    assert (wd / "gen_unfused" / name).read_bytes() == (
        wd / "gen_wav" / name).read_bytes()
    summary = json.loads((wd / "gen_fused2/decode_summary.json").read_text())
    assert summary["kernel"]["fused"] == 2
    assert (wd / "restored_fused2" / name).is_file()
    assert fused_ab.main([str(wd), "--fused", "2", "--device", "cpu"]) == res
