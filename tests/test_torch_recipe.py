"""The port's recipe on the CPU (`--device cpu`), at tests/test_recipe.py's
TINY sizes: its CLIs against the JAX package's on the same inputs, and the
recipe runner's stages 0-6 end to end, as tests/test_recipe.py drives the
JAX one.

Tolerances:
- feature extraction: the pooled numpy log-mel path exact (a numpy copy);
  the torch log-mel at rtol = atol = 1e-5 (tests/test_torch_data.py's);
  the world branch at atol 2e-4 on frames whose voicing agrees, at most 2%
  of frames flipping (tests/test_native_featext.py's); the energy channel
  exact;
- statistics: mean and std exact (the same float64 numpy), avg_mcep at
  atol 1e-4 (the mcep analysis's limit);
- noise shaping: the CLIs' wavs byte for byte (both on the native filter);
  the plain recursion's float output against JAX's at atol 2e-6;
- evaluation: the same keys; mcd_db, lsd_db and silence_db at atol 1e-3
  (mceps and spectra within 1e-4), the F0 RMSEs at rtol 1e-3 and the V/UV
  error rate at atol 0.02 (a frame's voicing may flip, the F0 suite's
  limit).
The HDF5 codec the port uses where h5py is missing writes files h5py
reads and reads h5py's; a recipe run through it gives h5py's statistics.
"""

import json
import logging
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.bin import calc_stats as jax_calc_stats
from shallow_wavenet_tpu.bin import feature_extract as jax_fe
from shallow_wavenet_tpu.bin import mcd_eval as jax_mcd_eval
from shallow_wavenet_tpu.bin import noise_shaping as jax_noise_shaping
from shallow_wavenet_tpu.config import get_config as jax_config
from shallow_wavenet_tpu.data.synthetic import synth_utterance
from shallow_wavenet_tpu_torch.bin import (
    calc_stats, feature_extract, mcd_eval, noise_shaping,
)
from shallow_wavenet_tpu_torch.bin import run as run_cli
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.data import hdf5_io
from shallow_wavenet_tpu_torch.data.audio_io import write_wav
from shallow_wavenet_tpu_torch.data.synthetic import make_corpus

TINY = [
    "data.sample_rate=8000", "data.n_fft=256", "data.hop_length=80",
    "data.win_length=200", "data.n_mels=16", "data.fmax=3800.0",
    "data.segment_length=800", "data.batch_size=2",
    "model.aux_channels=16", "model.stack_size=4",
    "model.residual_channels=16", "model.gate_channels=32",
    "model.skip_channels=24", "model.cond_channels=12",
    "model.upsample_factors=[4,5,4]", "model.compute_dtype=float32",
    "train.checkpoint_every=10", "train.log_every=5",
]
NS = ["noise_shaping.mcep_order=12"]
WORLD = ["data.feature_type=world", "model.aux_channels=19",
         "noise_shaping.mcep_order=12", "data.n_bap=4"]


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread: the models are tiny, and on a host
    shared with other test workers a thread pool per op costs more than it
    gives (the previous count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_stages(tmp_path, preset, extra=(), stages=(0, 6), steps=10,
               n_train=2, n_eval=1):
    run_cli.main([
        "--preset", preset, "--workdir", str(tmp_path),
        "--stage", str(stages[0]), "--stop-stage", str(stages[1]),
        "--steps", str(steps), "--n-train", str(n_train),
        "--n-eval", str(n_eval), "--device", "cpu", *TINY, *extra,
    ])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    make_corpus(root, n_train=2, n_eval=1, sample_rate=8000,
                duration_s=1.0, seed=1234, style="speechlike")
    return root


def _cfgs(preset, extra=()):
    over = [*TINY, *extra]
    return get_config(preset, over), jax_config(preset, over)


def _scp(corpus):
    return str(corpus / "train.scp")


def test_extract_one_against_jax(corpus):
    wp = (corpus / "train.scp").read_text().split()[0]
    cfg, jcfg = _cfgs("shallow_laplace_single",
                      ["data.energy_feature=true", "model.aux_channels=17"])
    pooled = feature_extract.extract_one(wp, cfg, numpy_only=True)
    assert np.array_equal(pooled, jax_fe.extract_one(wp, jcfg,
                                                     numpy_only=True))
    got = feature_extract.extract_one(wp, cfg, device="cpu")
    want = jax_fe.extract_one(wp, jcfg)
    assert got.shape == want.shape == (100, 17)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(got[:, -1], want[:, -1])


def test_extract_one_world_against_jax(corpus):
    wp = (corpus / "train.scp").read_text().split()[0]
    cfg, jcfg = _cfgs("shallow_laplace_ns", WORLD)
    got = feature_extract.extract_one(wp, cfg, device="cpu")
    want = jax_fe.extract_one(wp, jcfg)
    assert got.shape == want.shape == (100, 19)
    agree = got[:, 1] == want[:, 1]
    assert np.mean(~agree) < 0.02
    np.testing.assert_allclose(got[agree], want[agree], atol=2e-4)


def _feats(d):
    return {p.name: hdf5_io.read_hdf5(p, "feats")
            for p in sorted(Path(d).glob("*.h5"))}


def test_feature_cli_pool_and_torch_paths(corpus, tmp_path):
    common = ["--wav-scp", _scp(corpus), "--preset", "shallow_laplace_single",
              *TINY]
    feature_extract.main(["--outdir", str(tmp_path / "pool"),
                          "--num-workers", "2", "--device", "cpu", *common])
    feature_extract.main(["--outdir", str(tmp_path / "torch"), "--device",
                          "cpu", *common])
    jax_fe.main(["--outdir", str(tmp_path / "jax"), *common])
    pool, tor, jax = (_feats(tmp_path / d) for d in ("pool", "torch", "jax"))
    assert sorted(pool) == sorted(tor) == sorted(jax) == [
        "spk0_utt000.h5", "spk0_utt001.h5"]
    assert hdf5_io.list_hdf5(tmp_path / "pool/spk0_utt000.h5") == ["feats"]
    for k in jax:
        np.testing.assert_allclose(pool[k], jax[k], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tor[k], jax[k], rtol=1e-5, atol=1e-5)


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is available")
@pytest.mark.parametrize("cli", [feature_extract, calc_stats, noise_shaping,
                                 mcd_eval, run_cli])
def test_clis_need_the_card_unless_told_cpu(cli, tmp_path):
    """Without --device each CLI runs on the card, and raises here before
    it reads or writes anything."""
    argv = {feature_extract: ["--wav-scp", "x", "--outdir", "y"],
            calc_stats: ["--wav-scp", "x", "--feats-dir", "y", "--out", "z"],
            noise_shaping: ["--wav-scp", "x", "--stats", "y", "--outdir",
                            "z"],
            mcd_eval: ["--ref-scp", "x", "--gen-dir", "y"],
            run_cli: ["--workdir", str(tmp_path / "w")]}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([*argv, "--preset", "shallow_laplace_ns", *TINY])
    assert not (tmp_path / "w").exists()


@pytest.mark.parametrize("ns", [False, True])
def test_calc_stats_against_jax(corpus, tmp_path, ns):
    preset = "shallow_laplace_ns" if ns else "shallow_laplace_single"
    common = ["--wav-scp", _scp(corpus), "--preset", preset, *TINY, *NS]
    jax_fe.main(["--outdir", str(tmp_path / "feats"), *common])
    calc_stats.main(["--feats-dir", str(tmp_path / "feats"), "--out",
                     str(tmp_path / "port.h5"), "--device", "cpu", *common])
    jax_calc_stats.main(["--feats-dir", str(tmp_path / "feats"), "--out",
                         str(tmp_path / "jax.h5"), *common])
    names = hdf5_io.list_hdf5(tmp_path / "port.h5")
    assert names == hdf5_io.list_hdf5(tmp_path / "jax.h5")
    assert names == (["avg_mcep", "mean", "std"] if ns else ["mean", "std"])
    for k in ("mean", "std"):
        assert np.array_equal(hdf5_io.read_hdf5(tmp_path / "port.h5", k),
                              hdf5_io.read_hdf5(tmp_path / "jax.h5", k))
    if ns:
        np.testing.assert_allclose(
            hdf5_io.read_hdf5(tmp_path / "port.h5", "avg_mcep"),
            hdf5_io.read_hdf5(tmp_path / "jax.h5", "avg_mcep"), atol=1e-4)


@pytest.fixture(scope="module")
def shaped(corpus, tmp_path_factory):
    """The JAX recipe's stats for the corpus, and both CLIs' shaped wavs."""
    root = tmp_path_factory.mktemp("shaped")
    common = ["--wav-scp", _scp(corpus), "--preset", "shallow_laplace_ns",
              *TINY, *NS]
    jax_fe.main(["--outdir", str(root / "feats"), *common])
    jax_calc_stats.main(["--feats-dir", str(root / "feats"), "--out",
                         str(root / "stats.h5"), *common])
    for cli, out in ((noise_shaping, "port"), (jax_noise_shaping, "jax")):
        dev = ["--device", "cpu"] if cli is noise_shaping else []
        cli.main(["--stats", str(root / "stats.h5"), "--outdir",
                  str(root / out), *dev, *common])
    return root


def test_noise_shaping_against_jax(shaped, monkeypatch):
    port = sorted((shaped / "port").glob("*.wav"))
    assert [p.name for p in port] == ["spk0_utt000.wav", "spk0_utt001.wav"]
    for p in port:
        assert p.read_bytes() == (shaped / "jax" / p.name).read_bytes()
    cfg = get_config("shallow_laplace_ns", [*TINY, *NS])
    ns = cfg.noise_shaping
    stats = str(shaped / "stats.h5")
    b = noise_shaping.shaping_coefficients(stats, ns.mag, ns.alpha, "cpu")
    assert np.array_equal(b, jax_noise_shaping.shaping_coefficients(
        stats, ns.mag, ns.alpha))
    x = synth_utterance(3, 8000, 0.1)
    want = {inv: jax_noise_shaping.filter_waveform(x, b, ns.alpha,
                                                   ns.pade_order, inv)
            for inv in (False, True)}
    # the plain recursion, where the native library does not build
    monkeypatch.setattr(noise_shaping, "native_available", lambda: False)
    b_plain = noise_shaping.shaping_coefficients(stats, ns.mag, ns.alpha,
                                                 "cpu")
    np.testing.assert_allclose(b_plain, b, rtol=1e-5, atol=1e-7)
    for inv in (False, True):
        plain = noise_shaping.filter_waveform(x, b, ns.alpha, ns.pade_order,
                                              inv, "cpu")
        assert plain.dtype == np.float32
        np.testing.assert_allclose(plain, want[inv], atol=2e-6)


def test_noise_shaping_plain_path_logs_it(shaped, tmp_path, monkeypatch,
                                          caplog):
    monkeypatch.setattr(noise_shaping, "native_available", lambda: False)
    scp = tmp_path / "one.scp"
    scp.write_text(str(shaped / "port/spk0_utt000.wav") + "\n")
    with caplog.at_level(logging.INFO, logger="noise_shaping"):
        noise_shaping.main([
            "--wav-scp", str(scp), "--stats", str(shaped / "stats.h5"),
            "--outdir", str(tmp_path / "out"), "--inv", "--device", "cpu",
            "--preset", "shallow_laplace_ns", *TINY, *NS,
        ])
    assert any("plain recursion on cpu" in r.getMessage()
               for r in caplog.records)
    with wave.open(str(tmp_path / "out/spk0_utt000.wav")) as w:
        got = np.frombuffer(w.readframes(-1), "<i2")
    assert got.size == 8000 and np.abs(got).max() > 0


def test_mcd_eval_against_jax(corpus, tmp_path):
    """Reference: the eval wav with a silent stretch; generated: a noisy,
    gained copy, so every metric is defined."""
    from shallow_wavenet_tpu_torch.data.audio_io import read_wav

    src = Path((corpus / "eval.scp").read_text().split()[0])
    ref, sr = read_wav(src)
    ref[3000:4000] = 0.0
    rng = np.random.default_rng(0)
    gen = 0.8 * ref + 0.02 * rng.standard_normal(ref.size).astype(np.float32)
    ref_p = tmp_path / "ref" / src.name
    write_wav(ref_p, ref, sr)
    write_wav(tmp_path / "gen" / src.name, gen, sr)
    (tmp_path / "eval.scp").write_text(f"{ref_p}\n")
    common = ["--ref-scp", str(tmp_path / "eval.scp"), "--gen-dir",
              str(tmp_path / "gen"), "--preset", "shallow_laplace_ns",
              *TINY, *NS]
    got = mcd_eval.main(["--out", str(tmp_path / "port.json"), "--device",
                         "cpu", *common])
    want = jax_mcd_eval.main(["--out", str(tmp_path / "jax.json"), *common])
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        json.dumps(got))
    assert got.keys() == want.keys()
    g, w = got["per_utterance"][ref_p.name], want["per_utterance"][ref_p.name]
    assert g.keys() == w.keys()
    for k in ("mcd_db", "lsd_db", "silence_db"):
        assert g[k] is not None and abs(g[k] - w[k]) < 1e-3, (k, g[k], w[k])
    for k in ("f0_rmse_hz", "f0_rmse_cents"):
        np.testing.assert_allclose(g[k], w[k], rtol=1e-3)
    assert abs(g["vuv_error_rate"] - w["vuv_error_rate"]) <= 0.02
    assert g["lsd_frames_excluded"] == w["lsd_frames_excluded"]


def test_hdf5_codec_against_h5py(tmp_path):
    import h5py

    rng = np.random.default_rng(0)
    sets = {"feats": rng.standard_normal((37, 80)).astype(np.float32),
            "mean": rng.standard_normal(80),
            "ids": np.arange(10, dtype=np.int32)}
    sets.update({f"x{i}": np.full(3, i, np.float32) for i in range(9)})
    hdf5_io._write_file(tmp_path / "codec.h5", sets)
    with h5py.File(tmp_path / "codec.h5", "r") as f:
        assert sorted(f) == sorted(sets)
        for k, v in sets.items():
            assert f[k].dtype == v.dtype and np.array_equal(f[k][()], v)
    with h5py.File(tmp_path / "h5py.h5", "a") as f:
        for k, v in sets.items():
            f.create_dataset(k, data=v)
        del f["mean"]
        f.create_dataset("mean", data=sets["mean"] * 2)
    back = hdf5_io._read_file(tmp_path / "h5py.h5")
    assert sorted(back) == sorted(sets)
    for k, v in sets.items():
        assert np.array_equal(back[k], v * 2 if k == "mean" else v)


def test_recipe_through_the_codec_equals_h5py(tmp_path, monkeypatch):
    run_stages(tmp_path / "h5py", "shallow_laplace_ns", NS, stages=(0, 2))
    monkeypatch.setattr(hdf5_io, "_h5py", lambda: None)
    run_stages(tmp_path / "codec", "shallow_laplace_ns", NS, stages=(0, 2))
    for k in ("mean", "std", "avg_mcep"):
        assert np.array_equal(
            hdf5_io.read_hdf5(tmp_path / "codec/stats.h5", k),
            hdf5_io.read_hdf5(tmp_path / "h5py/stats.h5", k))
    monkeypatch.undo()
    import h5py

    with h5py.File(tmp_path / "codec/stats.h5", "r") as f:
        assert sorted(f) == ["avg_mcep", "mean", "std"]


def test_recipe_softmax_end_to_end(tmp_path):
    run_stages(tmp_path, "shallow_softmax_single")
    assert (tmp_path / "corpus/train.scp").exists()
    assert (tmp_path / "stats.h5").exists()
    assert (tmp_path / "model/metrics.jsonl").exists()
    gen = list((tmp_path / "gen_wav").glob("*.wav"))
    assert len(gen) == 1
    mcd = json.loads((tmp_path / "mcd.json").read_text())
    assert mcd["mcd_db_mean"] is not None and np.isfinite(mcd["mcd_db_mean"])
    summary = json.loads((tmp_path / "gen_wav/decode_summary.json")
                         .read_text())
    assert summary["model_step"] == 10


def test_recipe_noise_shaping_end_to_end(tmp_path):
    run_stages(tmp_path, "shallow_laplace_ns", NS)
    assert len(list((tmp_path / "shaped_wav").glob("*.wav"))) == 3
    assert len(list((tmp_path / "restored_wav").glob("*.wav"))) == 1
    mcd = json.loads((tmp_path / "mcd.json").read_text())
    for k in ("mcd_db_mean", "f0_rmse_hz_mean", "vuv_error_rate_mean",
              "lsd_db_mean"):
        assert k in mcd
    assert np.isfinite(mcd["mcd_db_mean"])


def test_recipe_multispeaker_one_process(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        run_stages(tmp_path, "multispk_dp", n_train=4,
                   extra=["noise_shaping.enabled=false",
                          "mesh.num_devices=2"])
    assert [r for r in caplog.records
            if "no launcher variable" in r.getMessage()]
    assert (tmp_path / "model/metrics.jsonl").exists()
    spks = {p.name.split("_")[0]
            for p in (tmp_path / "corpus/wav/train").iterdir()}
    assert len(spks) >= 2
    assert json.loads((tmp_path / "mcd.json").read_text())["mcd_db_mean"]


def test_recipe_external_corpus(tmp_path):
    ext = tmp_path / "external"
    ext.mkdir()

    def put(name, x, sr, ch=1, sw=2):
        x = np.asarray(x, np.float64)
        if ch == 2:
            x = np.stack([x, 0.5 * x], axis=1).reshape(-1)
        scale = {2: 32767, 3: 8388607}[sw]
        q = np.clip(np.round(x * scale), -scale - 1, scale).astype(np.int64)
        if sw == 2:
            frames = q.astype("<i2").tobytes()
        else:
            frames = b"".join(int(v).to_bytes(3, "little", signed=True)
                              for v in q)
        with wave.open(str(ext / name), "wb") as w:
            w.setnchannels(ch)
            w.setsampwidth(sw)
            w.setframerate(sr)
            w.writeframes(frames)

    put("a_24bit_22k.wav", synth_utterance(1, 22050, 1.3), 22050, sw=3)
    put("b_stereo_16k.wav", synth_utterance(2, 16000, 0.9), 16000, ch=2)
    silence = np.zeros(12000)
    silence[4000:6000] = synth_utterance(4, 8000, 0.25)[:2000]
    put("d_silence_heavy.wav", silence, 8000)
    put("e_eval_11k.wav", synth_utterance(5, 11025, 1.0), 11025)
    run_cli.main([
        "--preset", "shallow_softmax_single", "--workdir", str(tmp_path),
        "--stage", "0", "--stop-stage", "6", "--steps", "5",
        "--wav-dir", str(ext), "--n-eval", "1", "--device", "cpu", *TINY,
    ])
    assert len((tmp_path / "corpus/train.scp").read_text().split()) == 3
    mcd = json.loads((tmp_path / "mcd.json").read_text())
    assert np.isfinite(mcd["mcd_db_mean"])
    gen = list((tmp_path / "gen_wav").glob("*.wav"))
    assert [p.name for p in gen] == ["e_eval_11k.wav"]
    with wave.open(str(gen[0]), "rb") as w:
        assert abs(w.getnframes() - 8000) <= 80 * 2
        assert w.getframerate() == 8000


def test_recipe_stage_resume_and_duplicate_stems(tmp_path):
    run_stages(tmp_path, "shallow_softmax_single", stages=(0, 2))
    assert (tmp_path / "stats.h5").exists()
    assert not (tmp_path / "model").exists()
    run_stages(tmp_path, "shallow_softmax_single", stages=(4, 4), steps=5)
    recs = [json.loads(line) for line in
            (tmp_path / "model/metrics.jsonl").read_text().splitlines()]
    assert recs[-1]["step"] == 5
    assert not (tmp_path / "gen_wav").exists()
    # a train/eval stem collision is refused before any feature is written
    corpus = tmp_path / "dup/corpus"
    for sub in ("wav/train", "wav/eval"):
        (corpus / sub).mkdir(parents=True)
    w = (0.1 * np.sin(np.linspace(0, 400, 8000))).astype(np.float32)
    tr = corpus / "wav/train/spk0_utt000.wav"
    ev = corpus / "wav/eval/spk0_utt000.wav"
    write_wav(tr, w, 8000)
    write_wav(ev, w, 8000)
    (corpus / "train.scp").write_text(f"{tr}\n")
    (corpus / "eval.scp").write_text(f"{ev}\n")
    with pytest.raises(ValueError, match="duplicate wav stem"):
        run_stages(tmp_path / "dup", "shallow_softmax_single", stages=(1, 1))
