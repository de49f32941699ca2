"""The slice as a whole on the CPU: the port's copy-synthesis decode
(shallow_wavenet_tpu_torch.bin.decode) against the JAX `decode_batch` on a
random-init Trainer state, with the noise the JAX run draws; and the port's
CLI on a tiny HDF5 feature set. Tolerances as in test_torch_generate."""

import json
import wave

import h5py
import jax
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.bin.decode import decode_batch as jax_decode_batch
from shallow_wavenet_tpu.config import Config as JaxConfig
from shallow_wavenet_tpu.config import DataConfig
from shallow_wavenet_tpu.data.dataset import Utterance as JaxUtterance
from shallow_wavenet_tpu.training import Trainer
from shallow_wavenet_tpu_torch.bin import decode
from shallow_wavenet_tpu_torch.config import Config
from shallow_wavenet_tpu_torch.data.dataset import Utterance
from shallow_wavenet_tpu_torch.models.wavenet import (
    WaveNet, extract_plain_params, params_from_flax, save_params_npz,
)
from shallow_wavenet_tpu_torch.ops import ar_kernel

from tests.test_model import randomize_head, tiny_cfg
from tests.test_torch_generate import assert_same_samples


def _cfg(head):
    cfg = JaxConfig(name="tiny")
    cfg.model = tiny_cfg(head=head, n_stacks=2, stack_size=3)
    cfg.data = DataConfig(sample_rate=8000, hop_length=10, n_mels=8,
                          segment_length=40, batch_size=2)
    return cfg


def _feats(cfg, frames, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((f, cfg.model.aux_channels)).astype(np.float32)
            for f in frames]


def _state(cfg):
    state = Trainer(cfg).init_state()
    return state.replace(params=randomize_head({"params": state.params},
                                               seed=5)["params"])


def _port_model(cfg, state):
    pcfg = Config.from_dict(cfg.to_dict())
    tree = jax.tree.map(np.asarray, state.params)
    return pcfg, params_from_flax(WaveNet(pcfg.model), tree)


@pytest.mark.parametrize("head", ["laplace", "softmax"])
def test_decode_batch_matches_jax(head):
    cfg = _cfg(head)
    state = _state(cfg)
    feats = _feats(cfg, (9, 6, 12))
    key = jax.random.key(3)
    want = jax_decode_batch(Trainer(cfg), state, cfg,
                            [JaxUtterance(np.zeros(0), f) for f in feats], key,
                            use_pallas=False)
    T = max(f.shape[0] for f in feats) * cfg.data.hop_length
    noise = np.array(jax.random.uniform(key, (len(feats), T),
                                        minval=1e-7, maxval=1.0 - 1e-7))
    pcfg, model = _port_model(cfg, state)
    got = decode.decode_batch(model, pcfg,
                              [Utterance(np.zeros(0), f) for f in feats],
                              noise=torch.from_numpy(noise), device="cpu")
    assert len(got) == len(want) == 3
    for g, w, f in zip(got, want, feats):
        assert len(g) == len(w) == f.shape[0] * cfg.data.hop_length
        assert np.all(np.isfinite(g))
        assert_same_samples(cfg.model, g, w)


def test_decode_batch_segmented_equals_unsegmented():
    cfg = _cfg("laplace")
    pcfg, model = _port_model(cfg, _state(cfg))
    utts = [Utterance(np.zeros(0), f) for f in _feats(cfg, (30, 21), seed=1)]

    def run(seg):
        g = torch.Generator().manual_seed(7)
        return decode.decode_batch(model, pcfg, utts, generator=g,
                                   segment_samples=seg, device="cpu")

    for a, b in zip(run(0), run(128)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="segment-samples"):
        run(96)


def test_decode_batch_rows_stop_at_their_lengths():
    """decode_batch gives each row its utterance's length: the trimmed
    waveforms are the padded call's to the bit, and on the offline mix's
    frames (75-150, port_bench's offline_b8) the rows run 0.75 of the
    padded steps."""
    cfg = _cfg("laplace")
    pcfg, model = _port_model(cfg, _state(cfg))
    frames = (75, 86, 96, 107, 118, 129, 139, 150)
    utts = [Utterance(np.zeros(0), f) for f in _feats(cfg, frames, seed=2)]
    T = max(frames) * cfg.data.hop_length
    noise = torch.from_numpy(np.random.default_rng(3).uniform(
        1e-7, 1 - 1e-7, (len(frames), T)).astype(np.float32))
    ar_kernel.row_steps.clear()
    got = decode.decode_batch(model, pcfg, utts, noise=noise, device="cpu")
    assert ar_kernel.row_steps["run"] / ar_kernel.row_steps["padded"] == 0.75
    cond = torch.from_numpy(np.stack([np.pad(
        u.feats, ((0, max(frames) - len(u.feats)), (0, 0))) for u in utts]))
    padded = ar_kernel.generate(
        extract_plain_params(model), pcfg.model,
        model.upsample_cond(cond).detach(),
        noise=noise, device="cpu",
        layout=ar_kernel.choose_layout(pcfg.model, "auto", "cpu")).numpy()
    for g, p, f in zip(got, padded, frames):
        np.testing.assert_array_equal(g, p[:f * cfg.data.hop_length])



def test_every_caller_runs_the_chosen_layout(monkeypatch):
    """decode_batch (whole, segmented and split over devices), the
    streaming session and the pool take their layout from
    `ar_kernel.choose_layout` alone: with the chooser giving a sentinel
    (the fused window W = 2 on ar_generate, which none of them asks for),
    every kernel call runs it, on weights packed for it."""
    from shallow_wavenet_tpu_torch.models.streaming import (
        StreamingSynthesizer, StreamPool,
    )
    from shallow_wavenet_tpu_torch.models.wavenet import init_params_tree
    cfg = _cfg("laplace")
    pcfg = Config.from_dict(cfg.to_dict())
    model = params_from_flax(WaveNet(pcfg.model),
                             init_params_tree(pcfg.model, 0))
    hop = cfg.data.hop_length
    sentinel = ar_kernel.Layout(fused=2, chunk=32)
    asked, ran = [], []

    def choose(*args, **kw):
        asked.append(args)
        return sentinel

    real = ar_kernel.generate

    def generate(pp, mc, c_up, *args, layout=None, **kw):
        packed = pp.layout if isinstance(pp, ar_kernel.KernelWeights) \
            else None
        ran.append((layout, packed))
        return real(pp, mc, c_up, *args, layout=layout, **kw)

    monkeypatch.setattr(ar_kernel, "choose_layout", choose)
    monkeypatch.setattr(ar_kernel, "generate", generate)
    utts = [Utterance(np.zeros(0), f) for f in _feats(cfg, (8, 5), seed=4)]
    g = torch.Generator().manual_seed(8)
    for kw in ({}, {"segment_samples": 64}, {"devices": ["cpu", "cpu"]}):
        decode.decode_batch(model, pcfg, utts, generator=g, device="cpu",
                            **kw)
    frames = _feats(cfg, (12,), seed=5)[0]
    geometry = dict(block_frames=16, chunk=32, device="cpu")
    syn = StreamingSynthesizer(extract_plain_params(model), model,
                               pcfg.model, hop_length=hop, **geometry)
    syn.push(frames[None])
    syn.flush()
    pool = StreamPool(extract_plain_params(model), model, pcfg.model, hop,
                      slots=1, **geometry)
    sid = pool.open(seed=1)
    pool.push(sid, frames)
    pool.end(sid)
    while pool.active:
        pool.step()
    assert len(asked) == 5          # 3 decode calls, the session, the pool
    assert len(ran) == 1 + 2 + 2 + 1 + 1
    assert all(layout == sentinel and packed in (None, sentinel)
               for layout, packed in ran), ran

def test_decode_cli_writes_wavs_and_summary(tmp_path):
    cfg = _cfg("softmax")
    pcfg, _ = _port_model(cfg, _state(cfg))
    save_params_npz(tmp_path / "params.npz",
                    jax.tree.map(np.asarray, _state(cfg).params))
    (tmp_path / "config.json").write_text(pcfg.to_json())
    feats_dir = tmp_path / "feats"
    feats_dir.mkdir()
    frames = {"spk0_utt0": 5, "spk0_utt1": 3}
    for (name, f), x in zip(frames.items(), _feats(cfg, frames.values())):
        with h5py.File(feats_dir / f"{name}.h5", "w") as h:
            h.create_dataset("feats", data=x)
    with h5py.File(tmp_path / "stats.h5", "w") as h:
        h.create_dataset("mean", data=np.zeros(8, np.float32))
        h.create_dataset("std", data=np.ones(8, np.float32))
    (tmp_path / "eval.scp").write_text(
        "".join(f"/corpus/{n}.wav\n" for n in frames))
    out = tmp_path / "out"
    decode.main(["--config", str(tmp_path / "config.json"),
                 "--eval-scp", str(tmp_path / "eval.scp"),
                 "--feats-dir", str(feats_dir),
                 "--stats", str(tmp_path / "stats.h5"),
                 "--params", str(tmp_path / "params.npz"),
                 "--outdir", str(out), "--batch-size", "1",
                 "--kernel-dtype", "bfloat16", "--device", "cpu"])
    summary = json.loads((out / "decode_summary.json").read_text())
    assert set(summary) == {"utterances", "model_step", "audio_seconds",
                            "wall_seconds", "rtf", "audio_seconds_per_s",
                            "kernel"}
    assert summary["kernel"] == {"dtype": "bfloat16", "fused": 0,
                                 "cluster": 4, "wide": False,
                                 "resident": True, "stream": False,
                                 "chunk": 64}
    assert summary["utterances"] == 2
    assert summary["audio_seconds"] == pytest.approx(80 / 8000)
    for name, f in frames.items():
        with wave.open(str(out / f"{name}.wav")) as w:
            assert w.getnframes() == f * cfg.data.hop_length
            assert w.getframerate() == 8000


def test_decode_cli_fused(tmp_path):
    """--fused W reaches the plain generator and the summary; the samples
    stay within the fused window's tolerance of the unfused decode."""
    cfg = _cfg("laplace")
    state = _state(cfg)
    pcfg, model = _port_model(cfg, state)
    save_params_npz(tmp_path / "params.npz",
                    jax.tree.map(np.asarray, state.params))
    (tmp_path / "config.json").write_text(pcfg.to_json())
    feats_dir = tmp_path / "feats"
    feats_dir.mkdir()
    with h5py.File(feats_dir / "spk0_utt0.h5", "w") as h:
        h.create_dataset("feats", data=_feats(cfg, (7,))[0])
    (tmp_path / "eval.scp").write_text("/corpus/spk0_utt0.wav\n")
    def run(fused):
        out = tmp_path / f"out{fused}"
        decode.main(["--config", str(tmp_path / "config.json"),
                     "--eval-scp", str(tmp_path / "eval.scp"),
                     "--feats-dir", str(feats_dir),
                     "--params", str(tmp_path / "params.npz"),
                     "--outdir", str(out), "--fused", str(fused),
                     "--device", "cpu"])
        return out

    wavs = {}
    for fused in (0, 3):
        out = run(fused)
        summary = json.loads((out / "decode_summary.json").read_text())
        assert summary["kernel"] == {"dtype": "float32", "fused": fused,
                                     "cluster": 4, "wide": False,
                                     "resident": True, "stream": False,
                                     "chunk": 64}
        with wave.open(str(out / "spk0_utt0.wav")) as w:
            wavs[fused] = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    assert len(wavs[3]) == 7 * cfg.data.hop_length
    assert np.abs(wavs[3].astype(int) - wavs[0].astype(int)).max() <= 1
    with pytest.raises(ValueError, match="fused"):
        run(-1)


def test_decode_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """device=None means CUDA: without it the decode entry points raise
    instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg("laplace")
    pcfg, model = _port_model(cfg, _state(cfg))
    utts = [Utterance(np.zeros(0), f) for f in _feats(cfg, (4,))]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode.decode_batch(model, pcfg, utts,
                            generator=torch.Generator().manual_seed(0))
    (tmp_path / "config.json").write_text(pcfg.to_json())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode.main(["--config", str(tmp_path / "config.json"),
                     "--eval-scp", "x", "--feats-dir", "x",
                     "--params", "x", "--outdir", str(tmp_path / "o")])
