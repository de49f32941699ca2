"""The port's data path against the JAX package's on the CPU: the segment
sampler draw for draw (to the bit, with and without silence_boost), its
state replay, the prefetcher and group sampler, wav reading and resampling,
the synthetic corpus byte for byte, the corpus loader, the high-pass, and
the log-mel features.

Tolerances: every numpy copy is exact (0.0). The torch log-mel against
JAX's at rtol = atol = 1e-5 (tests/test_stft.py's batched-against-single
limit; measured 6e-7 at these shapes), the torch batched against single
likewise."""

import json
import wave

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.bin.common import load_utterances as jax_load
from shallow_wavenet_tpu.data import audio_io as jax_audio
from shallow_wavenet_tpu.data import dataset as jax_dataset
from shallow_wavenet_tpu.data import synthetic as jax_synthetic
from shallow_wavenet_tpu.ops import filters as jax_filters
from shallow_wavenet_tpu.ops import stft as jax_stft
from shallow_wavenet_tpu_torch.bin.common import load_utterances
from shallow_wavenet_tpu_torch.data import audio_io, dataset, synthetic
from shallow_wavenet_tpu_torch.data.prefetch import GroupSampler, Prefetcher
from shallow_wavenet_tpu_torch.ops import filters, stft
from shallow_wavenet_tpu_torch.training.trainer import _json_safe

SR, NFFT, HOP, WIN, NMELS = 16000, 512, 80, 400, 32


def _utts(module, n=3, hop=80, nm=8, seed=0):
    """Speech-like utterances (voiced, unvoiced and silent stretches, so
    the silence pool is not empty) with random features, as `module`'s
    Utterance."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        wav, _, _ = synthetic.synth_utterance_speechlike(seed + i, 8000, 0.6)
        feats = rng.standard_normal((len(wav) // hop, nm)).astype(np.float32)
        out.append(module.Utterance(wav=wav, feats=feats, speaker=i))
    return out


def _sampler(module, seed=3, silence_boost=0.0, **kw):
    kw = {"batch_size": 3, "segment_length": 800, "hop_length": 80,
          "receptive_field": 127, **kw}
    return module.SegmentSampler(_utts(module), seed=seed,
                                 silence_boost=silence_boost, **kw)


@pytest.mark.parametrize("silence_boost", [0.0, 0.5])
def test_segment_sampler_draws_the_jax_batches(silence_boost):
    ours = _sampler(dataset, silence_boost=silence_boost)
    ref = _sampler(jax_dataset, silence_boost=silence_boost)
    if silence_boost:
        assert ours._sil_ui.size > 0
        np.testing.assert_array_equal(ours._sil_f0, ref._sil_f0)
    for _ in range(12):
        a, b = next(ours), next(ref)
        assert set(a) == set(b) == {"x", "cond", "speaker"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ours.state() == ref.state()


def test_segment_sampler_state_replays_through_json():
    s = _sampler(dataset, silence_boost=0.5)
    for _ in range(3):
        next(s)
    st = json.loads(json.dumps(_json_safe(s.state())))
    want = [next(s) for _ in range(2)]
    s2 = _sampler(dataset, silence_boost=0.5, seed=99)
    s2.set_state(st)
    for w in want:
        got = next(s2)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k])
    # the JAX sampler replays the port's state
    ref = _sampler(jax_dataset, silence_boost=0.5, seed=99)
    ref.set_state(st)
    np.testing.assert_array_equal(next(ref)["x"], want[0]["x"])


def test_shard_list_and_file_list(tmp_path):
    items = [f"u{i}" for i in range(11)]
    for count in (1, 2, 3, 4):
        for idx in range(count):
            assert (dataset.shard_list(items, idx, count)
                    == jax_dataset.shard_list(items, idx, count))
    assert sorted(sum((dataset.shard_list(items, i, 3) for i in range(3)),
                      [])) == sorted(items)
    (tmp_path / "a.scp").write_text("# c\n\nid1 /x/a.wav\n/y/b.wav\n")
    assert (dataset.read_file_list(tmp_path / "a.scp")
            == jax_dataset.read_file_list(tmp_path / "a.scp"))


def test_group_sampler_tail_exact_state():
    """With a step budget that is not a multiple of K, the final group is
    tail-sized and the sampler state reflects exactly the batches
    consumed."""
    kw = {"segment_length": 40, "hop_length": 8, "receptive_field": 16,
          "batch_size": 2}
    gs = GroupSampler(_sampler(dataset, seed=0, **kw), 8, total=20)
    groups = list(gs)
    assert [g["x"].shape[0] for g in groups] == [8, 8, 4]
    ref = _sampler(dataset, seed=0, **kw)
    flat = [g["x"][i] for g in groups for i in range(g["x"].shape[0])]
    for got in flat:
        np.testing.assert_array_equal(got, next(ref)["x"])
    assert gs.state() == ref.state()


def test_prefetcher_order_state_and_put_fn():
    pf = Prefetcher(_sampler(dataset), put_fn=lambda b: {
        k: torch.as_tensor(v) for k, v in b.items()})
    ref = _sampler(dataset)
    for _ in range(3):
        got = next(pf)
        assert isinstance(got["x"], torch.Tensor)
        np.testing.assert_array_equal(got["x"].numpy(), next(ref)["x"])
    st = pf.state()
    want = next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    # state() describes consumed batches only
    s2 = _sampler(dataset)
    s2.set_state(st)
    np.testing.assert_array_equal(next(s2)["x"], want["x"].numpy())


def test_prefetcher_propagates_errors():
    def gen():
        yield {"x": np.zeros(3)}
        raise RuntimeError("boom")

    g = gen()

    class It:
        def __next__(self):
            return next(g)

    pf = Prefetcher(It())
    next(pf)
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)
    pf.close()


def _write_raw_wav(path, frames, ch, sw, sr):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(sw)
        w.setframerate(sr)
        w.writeframes(frames)


def test_read_wav_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    cases = {
        "w8": (rng.integers(0, 256, 64).astype(np.uint8).tobytes(), 1, 1),
        "w16": (rng.integers(-32768, 32768, 64).astype("<i2").tobytes(), 1, 2),
        "w24": (b"".join(int(v).to_bytes(3, "little", signed=True) for v in
                         rng.integers(-2 ** 23, 2 ** 23, 64)), 1, 3),
        "w32": (rng.integers(-2 ** 31, 2 ** 31, 64).astype("<i4").tobytes(),
                1, 4),
        "st16": (rng.integers(-32768, 32768, 128).astype("<i2").tobytes(),
                 2, 2),
    }
    for name, (raw, ch, sw) in cases.items():
        p = tmp_path / f"{name}.wav"
        _write_raw_wav(p, raw, ch, sw, 16000)
        for target in (0, 16000, 8000, 24000):
            a, sr_a = audio_io.read_wav(p, target_sr=target)
            b, sr_b = jax_audio.read_wav(p, target_sr=target)
            assert sr_a == sr_b and a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    x = rng.standard_normal(999).astype(np.float32)
    for sr_in, sr_out in ((48000, 16000), (16000, 24000), (22050, 16000),
                          (8000, 8000)):
        np.testing.assert_array_equal(audio_io.resample(x, sr_in, sr_out),
                                      jax_audio.resample(x, sr_in, sr_out))


@pytest.mark.parametrize("kw", [
    {"style": "harmonic"},
    {"style": "speechlike", "n_speakers": 2, "f0_range": (80.0, 340.0)},
    {"style": "formant", "n_speakers": 3},
])
def test_make_corpus_writes_the_jax_corpus(tmp_path, kw):
    args = {"n_train": 3, "n_eval": 2, "sample_rate": 8000,
            "duration_s": 0.3, "seed": 11, **kw}
    ours = synthetic.make_corpus(tmp_path / "a", **args)
    ref = jax_synthetic.make_corpus(tmp_path / "b", **args)
    for split in ("train", "eval"):
        assert ([p.replace(str(tmp_path / "a"), "") for p in ours[split]]
                == [p.replace(str(tmp_path / "b"), "") for p in ref[split]])
        for pa, pb in zip(ours[split], ref[split]):
            assert open(pa, "rb").read() == open(pb, "rb").read()
            assert synthetic.speaker_of(pa) == jax_synthetic.speaker_of(pb)
    np.testing.assert_array_equal(synthetic.synth_utterance(5, 8000, 0.2),
                                  jax_synthetic.synth_utterance(5, 8000, 0.2))


def test_highpass_and_load_utterances_match_jax(tmp_path):
    lists = synthetic.make_corpus(tmp_path, n_train=2, n_eval=0,
                                  sample_rate=16000, duration_s=0.2,
                                  n_speakers=2)
    x, _ = audio_io.read_wav(lists["train"][0])
    np.testing.assert_array_equal(filters.highpass(x, 16000, 70.0),
                                  jax_filters.highpass(x, 16000, 70.0))
    assert filters.highpass(x, 16000, 0.0) is x
    feats = tmp_path / "feats"
    feats.mkdir()
    rng = np.random.default_rng(1)
    for p in lists["train"]:
        with h5py.File(feats / (p.split("/")[-1][:-4] + ".h5"), "w") as h:
            h.create_dataset("feats", data=rng.standard_normal(
                (25, 4)).astype(np.float32))
    with h5py.File(tmp_path / "stats.h5", "w") as h:
        h.create_dataset("mean", data=np.full(4, 0.5, np.float32))
        h.create_dataset("std", data=np.full(4, 2.0, np.float32))
    for kw in ({}, {"highpass_cutoff": 70.0, "sample_rate": 8000},
               {"load_wav": False}):
        ours = load_utterances(tmp_path / "train.scp", feats,
                               tmp_path / "stats.h5", **kw)
        ref = jax_load(tmp_path / "train.scp", feats, tmp_path / "stats.h5",
                       **kw)
        for a, b in zip(ours, ref, strict=True):
            np.testing.assert_array_equal(a.wav, b.wav)
            np.testing.assert_array_equal(a.feats, b.feats)
            assert a.speaker == b.speaker


def test_log_mel_matches_jax():
    rng = np.random.default_rng(7)
    assert np.array_equal(stft.mel_filterbank(SR, NFFT, NMELS, 40.0, 7600.0),
                          jax_stft.mel_filterbank(SR, NFFT, NMELS, 40.0,
                                                  7600.0))
    xs = rng.standard_normal((3, SR // 4)).astype(np.float32)
    want = np.asarray(jax_stft.log_mel_spectrogram(
        jnp.asarray(xs), SR, NFFT, HOP, WIN, NMELS, 40.0, 7600.0))
    got = stft.log_mel_spectrogram(torch.from_numpy(xs), SR, NFFT, HOP, WIN,
                                   NMELS, 40.0, 7600.0)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    single = torch.stack([stft.log_mel_spectrogram(
        torch.from_numpy(x), SR, NFFT, HOP, WIN, NMELS, 40.0, 7600.0)
        for x in xs])
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the numpy mirror is the JAX module's copy: equal to the bit
    np.testing.assert_array_equal(
        stft.log_mel_spectrogram_np(xs[0], SR, NFFT, HOP, WIN, NMELS, 40.0,
                                    7600.0),
        jax_stft.log_mel_spectrogram_np(xs[0], SR, NFFT, HOP, WIN, NMELS,
                                        40.0, 7600.0))
    mag = stft.stft_magnitude(torch.from_numpy(xs[0]), NFFT, HOP, WIN)
    ref = np.asarray(jax_stft.stft_magnitude(jnp.asarray(xs[0]), NFFT, HOP,
                                             WIN))
    np.testing.assert_allclose(mag.numpy(), ref, rtol=1e-5, atol=1e-4)
