"""The port's training loop on the CPU, the behaviour tests of
tests/test_train.py on shallow_wavenet_tpu_torch: the loss falls for both
heads; resume is exact, to the bit; restore without a checkpoint is a
no-op; warm start and its missing-checkpoint error; K updates per
multi_step call equal K single steps, to the bit, remainder and resume
included; grad_accum equals the big batch; context dropout's mask. Then the
CLIs: bin/train.py on a synthetic corpus with the port's log-mel features,
and bin/decode.py --workdir on its checkpoint; bin/train.py accepts
--profile and --debug-nans."""

import dataclasses
import json
import wave

import h5py
import numpy as np
import pytest
import torch
from torch.func import functional_call

from shallow_wavenet_tpu_torch.bin import decode, train
from shallow_wavenet_tpu_torch.config import (
    Config, DataConfig, ModelConfig, TrainConfig,
)
from shallow_wavenet_tpu_torch.data.audio_io import read_wav
from shallow_wavenet_tpu_torch.data.dataset import SegmentSampler, Utterance
from shallow_wavenet_tpu_torch.data.synthetic import (
    make_corpus, synth_utterance,
)
from shallow_wavenet_tpu_torch.models import heads
from shallow_wavenet_tpu_torch.ops.stft import log_mel_spectrogram
from shallow_wavenet_tpu_torch.training import Trainer


def tiny_train_cfg(head="laplace", **train) -> Config:
    """tests/test_train.py's tiny_train_cfg."""
    c = Config(name="test")
    c.model = ModelConfig(
        n_stacks=1, stack_size=4, residual_channels=16, gate_channels=32,
        skip_channels=24, aux_channels=8, head=head,
        upsample_factors=(4, 5, 4), cond_channels=12,
        compute_dtype="float32",
    )
    c.data = DataConfig(sample_rate=8000, n_fft=256, hop_length=80,
                        win_length=200, n_mels=8, fmax=3800.0,
                        segment_length=800, batch_size=2)
    c.train = TrainConfig(**{"steps": 60, "learning_rate": 3e-3,
                             "checkpoint_every": 30, "log_every": 10,
                             "seed": 0, **train})
    return c


def log_mel(cfg, wav):
    d = cfg.data
    return log_mel_spectrogram(torch.from_numpy(wav), d.sample_rate, d.n_fft,
                               d.hop_length, d.win_length, d.n_mels, d.fmin,
                               d.fmax).numpy()[: len(wav) // d.hop_length]


def make_sampler(cfg, n_utts=2, seed=0):
    utts = []
    for i in range(n_utts):
        wav = synth_utterance(seed + i, cfg.data.sample_rate, 0.5)
        utts.append(Utterance(wav=wav, feats=log_mel(cfg, wav)))
    return SegmentSampler(
        utts, batch_size=cfg.data.batch_size,
        segment_length=cfg.data.segment_length,
        hop_length=cfg.data.hop_length,
        receptive_field=cfg.model.receptive_field, seed=seed)


def records(workdir):
    return [json.loads(line) for line in
            (workdir / "metrics.jsonl").read_text().splitlines()]


def fit(cfg, workdir, steps, state=None, sampler=None):
    tr = Trainer(cfg, "cpu")
    return tr.fit(tr.init_state() if state is None else state,
                  make_sampler(cfg) if sampler is None else sampler,
                  workdir, steps=steps)


@pytest.mark.parametrize("head,steps,lr", [("laplace", 60, 3e-3),
                                           ("softmax", 250, 2e-3)])
def test_loss_decreases(tmp_path, head, steps, lr):
    cfg = tiny_train_cfg(head)
    cfg.train = dataclasses.replace(cfg.train, learning_rate=lr)
    state = fit(cfg, tmp_path, steps)
    ls = [r["loss"] for r in records(tmp_path)]
    assert state.step == steps
    if head == "laplace":
        assert ls[-1] < ls[0] - 0.5, ls
    else:
        # CE starts near ln(256) ~ 5.55
        assert ls[0] > 4.5 and min(ls[-3:]) < ls[0] - 1.0, ls
    rec = records(tmp_path)[-1]
    assert set(rec) == {"step", "loss", "grad_norm", "steps_per_s",
                        "samples_per_s"}
    written = Config.from_json((tmp_path / "config.json").read_text())
    assert written.to_dict() == cfg.to_dict()


def test_resume_is_exact(tmp_path):
    """Stopped at a checkpoint and resumed, the run ends on the straight
    run's parameters, moments and metrics, bit for bit."""
    cfg = tiny_train_cfg(checkpoint_every=10, log_every=5)
    straight = fit(cfg, tmp_path / "a", 30)
    fit(cfg, tmp_path / "b", 20)
    tr = Trainer(cfg, "cpu")
    state, sampler_state, step = tr.restore(tmp_path / "b", tr.init_state())
    assert step == state.step == 20 and sampler_state is not None
    sampler = make_sampler(cfg)
    sampler.set_state(sampler_state)
    resumed = tr.fit(state, sampler, tmp_path / "b", steps=30)
    assert resumed.step == 30
    assert torch.equal(resumed.params, straight.params)
    for k in ("mu", "nu"):
        assert torch.equal(resumed.opt_state[k], straight.opt_state[k])
    a, b = records(tmp_path / "a"), records(tmp_path / "b")
    assert ([(r["step"], r["loss"], r["grad_norm"]) for r in a]
            == [(r["step"], r["loss"], r["grad_norm"]) for r in b])
    # the checkpoint holds what the state holds, in the flax layout
    again, _, _ = tr.restore(tmp_path / "b", tr.init_state(seed=5))
    assert torch.equal(again.params, resumed.params)
    assert sorted(p.name for p in (tmp_path / "b/checkpoints").iterdir()) \
        == ["10", "20", "30"]


def test_keeps_the_newest_checkpoints(tmp_path):
    cfg = tiny_train_cfg(checkpoint_every=2, keep_checkpoints=2)
    fit(cfg, tmp_path, 7)
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) \
        == ["6", "7"]
    assert (tmp_path / "checkpoints/7/params.npz").is_file()


def test_restore_without_checkpoint_is_noop(tmp_path):
    tr = Trainer(tiny_train_cfg(), "cpu")
    s = tr.init_state()
    s2, sampler_state, step = tr.restore(tmp_path / "empty", s)
    assert s2 is s and step == 0 and sampler_state is None


def test_warm_start_finetune(tmp_path):
    """warm_start copies the source run's latest params into a fresh
    state with optimizer and step reset; its first losses start well
    below a cold start's."""
    cfg = tiny_train_cfg()
    tr = Trainer(cfg, "cpu")
    src, ft = tmp_path / "pretrain", tmp_path / "finetune"
    state = fit(cfg, src, 60)
    warm = tr.warm_start(src, tr.init_state())
    assert warm.step == 0 and torch.equal(warm.params, state.params)
    assert not warm.opt_state["mu"].any()
    tr.fit(warm, make_sampler(cfg, seed=7), ft, steps=20)
    assert records(ft)[0]["loss"] < records(src)[0]["loss"] - 0.5
    with pytest.raises(FileNotFoundError):
        tr.warm_start(tmp_path / "nowhere", tr.init_state())


def test_multi_step_equals_single_step(tmp_path):
    """steps_per_call = 8: the same updates in the same order as single
    steps, to the bit; 30 steps end on a tail group of 6, and the
    checkpoint after it holds the sampler state of exactly 30 draws."""
    cfg1 = tiny_train_cfg(checkpoint_every=10)
    cfg8 = tiny_train_cfg(checkpoint_every=10, steps_per_call=8)
    st1 = fit(cfg1, tmp_path / "a", 30)
    st8 = fit(cfg8, tmp_path / "b", 30)
    assert st1.step == st8.step == 30
    assert torch.equal(st1.params, st8.params)
    tr = Trainer(cfg8, "cpu")
    restored, sampler_state, step = tr.restore(tmp_path / "b",
                                               tr.init_state())
    assert step == 30 and torch.equal(restored.params, st8.params)
    ref = make_sampler(cfg8)
    for _ in range(30):
        next(ref)
    assert json.loads(json.dumps(ref.state())) == sampler_state
    # checkpoints at the group boundaries that crossed a multiple of 10
    assert sorted(int(p.name) for p in (tmp_path / "b/checkpoints").iterdir()
                  ) == [16, 24, 30]


def test_multi_step_metrics():
    cfg = tiny_train_cfg()
    tr = Trainer(cfg, "cpu")
    sampler = make_sampler(cfg)
    batches = [next(sampler) for _ in range(3)]
    group = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    s3, ms = tr.multi_step(tr.init_state(), group)
    s = tr.init_state()
    for i, b in enumerate(batches):
        s, m = tr.step(s, b)
        assert torch.equal(ms["loss"][i], m["loss"])
        assert torch.equal(ms["grad_norm"][i], m["grad_norm"])
    assert s3.step == 3 and torch.equal(s3.params, s.params)


def test_grad_accum_matches_big_batch():
    cfg1 = tiny_train_cfg()
    cfg1.data = dataclasses.replace(cfg1.data, batch_size=4)
    cfg2 = tiny_train_cfg(grad_accum=4)
    cfg2.data = dataclasses.replace(cfg2.data, batch_size=4)
    tr1, tr2 = Trainer(cfg1, "cpu"), Trainer(cfg2, "cpu")
    s1, s2 = tr1.init_state(), tr2.init_state()
    sampler = make_sampler(cfg1)
    for _ in range(6):
        b = next(sampler)
        s1, m1 = tr1.step(s1, b)
        s2, m2 = tr2.step(s2, b)
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s1.params.numpy(), s2.params.numpy(),
                               rtol=2e-5, atol=2e-6)
    cfg3 = tiny_train_cfg(grad_accum=3)
    tr3 = Trainer(cfg3, "cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        tr3.step(tr3.init_state(), next(make_sampler(cfg3)))


def test_batch_checks_raise():
    cfg = tiny_train_cfg()
    tr = Trainer(cfg, "cpu")
    b = next(make_sampler(cfg))
    bad = [{**b, "x": b["x"][None]},
           {**b, "x": b["x"].astype(np.float64)},
           {**b, "cond": b["cond"][:, :-1]},
           {**b, "cond": b["cond"][..., :-1]}]
    for batch in bad:
        with pytest.raises(ValueError):
            tr.step(tr.init_state(), batch)


def test_context_dropout_mask_structure():
    """Whole spans of the input copy are zeroed: span-aligned,
    rate-controlled, deterministic per generator seed, distinct per step
    and microbatch."""
    cfg = tiny_train_cfg(context_dropout=0.5, context_dropout_span_ms=10.0)
    tr = Trainer(cfg, "cpu")
    x = torch.ones(2, 1000)
    y = tr._context_dropout(x, tr._dropout_generator(3, 0)).numpy()
    span = 80                                # 10 ms at 8 kHz
    assert set(np.unique(y).tolist()) <= {0.0, 1.0}
    for b in range(2):
        for s in range(0, 1000, span):
            seg = y[b, s:s + span]
            assert seg.min() == seg.max(), "mask must be constant per span"
    assert 0.0 < y.mean() < 1.0
    again = tr._context_dropout(x, tr._dropout_generator(3, 0)).numpy()
    np.testing.assert_array_equal(y, again)
    big = torch.ones(4, 8000)
    masks = [tr._context_dropout(big, tr._dropout_generator(s, m)).numpy()
             for s, m in ((3, 0), (4, 0), (3, 1))]
    assert not np.array_equal(masks[0], masks[1])
    assert not np.array_equal(masks[0], masks[2])


def test_context_dropout_step_deterministic_and_distinct():
    """The mask is keyed on (seed, step): one state stepped twice gives
    the same loss; the knob moves the loss against the knob-off trainer;
    with grad_accum each microbatch draws its own mask and training
    steps."""
    cfg0 = tiny_train_cfg()
    cfg1 = tiny_train_cfg(context_dropout=0.3, context_dropout_span_ms=10.0)
    tr0, tr1 = Trainer(cfg0, "cpu"), Trainer(cfg1, "cpu")
    sampler = make_sampler(cfg1)
    state = tr1.init_state()
    for _ in range(4):        # the head is zero at init: warm it
        state, _ = tr1.step(state, next(sampler))
    b = next(sampler)
    _, m_a = tr1.step(state, b)
    _, m_b = tr1.step(state, b)
    assert torch.equal(m_a["loss"], m_b["loss"])
    off = tr0.eval_loss(state, [b])
    assert float(m_a["loss"]) != off
    cfg2 = tiny_train_cfg(grad_accum=2, context_dropout=0.3)
    cfg2.data = dataclasses.replace(cfg2.data, batch_size=4)
    tr2 = Trainer(cfg2, "cpu")
    s2 = tr2.init_state()
    sampler = make_sampler(cfg2)
    for _ in range(3):
        s2, m = tr2.step(s2, next(sampler))
        assert np.isfinite(float(m["loss"]))
    assert s2.step == 3


def test_context_dropout_full_mask_zeroes_input_only():
    """rate 1 with one giant span zeroes the whole AR input and leaves the
    targets: the loss equals a hand-built loss on a zeroed input with the
    original waveform's targets."""
    cfg = tiny_train_cfg(context_dropout=1.0, context_dropout_span_ms=1e6)
    tr = Trainer(cfg, "cpu")
    sampler = make_sampler(cfg)
    state = tr.init_state()
    for _ in range(4):
        state, _ = tr.step(state, next(sampler))
    b = tr.to_device(next(sampler))
    loss = tr._loss_fn(state.params, b, tr._dropout_generator(0, 0))
    x, cond = b["x"], b["cond"]
    out = functional_call(tr.model, tr._views(state.params),
                          (torch.zeros_like(x[:, :-1]), cond, None))
    t = x.shape[1] - 1
    mask = (torch.arange(t) >= t - cfg.data.segment_length).float()[None]
    want = heads.laplace_loss(out, x[:, 1:], cfg.model.log_b_min,
                              cfg.model.log_b_max, mask)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6,
                               atol=1e-7)
    assert float(loss) != tr.eval_loss(state, [next(make_sampler(cfg))])


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """device=None means CUDA: without it the trainer and the CLI raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tiny_train_cfg())
    (tmp_path / "config.json").write_text(tiny_train_cfg().to_json())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--config", str(tmp_path / "config.json"),
                    "--train-scp", "x", "--feats-dir", "x",
                    "--workdir", str(tmp_path / "w")])


def _corpus(tmp_path, cfg):
    """A synthetic corpus with the port's log-mel features and stats."""
    lists = make_corpus(tmp_path / "corpus", n_train=3, n_eval=1,
                        sample_rate=cfg.data.sample_rate, duration_s=0.25)
    feats = tmp_path / "feats"
    feats.mkdir()
    all_feats = []
    for p in lists["train"] + lists["eval"]:
        wav, _ = read_wav(p)
        f = log_mel(cfg, wav)
        all_feats.append(f)
        with h5py.File(feats / (p.split("/")[-1][:-4] + ".h5"), "w") as h:
            h.create_dataset("feats", data=f)
    cat = np.concatenate(all_feats)
    with h5py.File(tmp_path / "stats.h5", "w") as h:
        h.create_dataset("mean", data=cat.mean(0))
        h.create_dataset("std", data=cat.std(0))
    return feats


def test_train_and_decode_cli(tmp_path):
    cfg = tiny_train_cfg(checkpoint_every=4, log_every=2)
    cfg.data = dataclasses.replace(cfg.data, segment_length=400)
    (tmp_path / "config.json").write_text(cfg.to_json())
    feats = _corpus(tmp_path, cfg)
    common = ["--config", str(tmp_path / "config.json"),
              "--feats-dir", str(feats), "--stats", str(tmp_path / "stats.h5")]
    workdir = tmp_path / "exp"
    train.main(common + ["--train-scp", str(tmp_path / "corpus/train.scp"),
                         "--dev-scp", str(tmp_path / "corpus/eval.scp"),
                         "--workdir", str(workdir), "--steps", "6",
                         "--device", "cpu"])
    recs = records(workdir)
    assert [r["step"] for r in recs] == [2, 4, 6]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert "eval_loss" in recs[1] and "eval_loss" in recs[2]
    assert sorted(p.name for p in (workdir / "checkpoints").iterdir()) \
        == ["4", "6"]
    # a second run resumes at 6 and has nothing left to do
    train.main(common + ["--train-scp", str(tmp_path / "corpus/train.scp"),
                         "--workdir", str(workdir), "--steps", "6",
                         "--device", "cpu"])
    assert len(records(workdir)) == 3

    out = tmp_path / "out"
    dec = common + ["--eval-scp", str(tmp_path / "corpus/eval.scp"),
                    "--outdir", str(out), "--device", "cpu"]
    decode.main(dec + ["--workdir", str(workdir)])
    summary = json.loads((out / "decode_summary.json").read_text())
    assert summary["model_step"] == 6 and summary["utterances"] == 1
    with wave.open(str(out / "spk0_utt003.wav")) as w:
        assert w.getnframes() == 0.25 * 8000 // 80 * 80
    with pytest.raises(SystemExit):          # both
        decode.main(dec + ["--workdir", str(workdir), "--params", "p.npz"])
    with pytest.raises(SystemExit):          # neither
        decode.main(dec)
    # --profile and --debug-nans are accepted: the run resumes at 6 with
    # nothing left to do, and the profiler writes its trace
    train.main(common + ["--train-scp", str(tmp_path / "corpus/train.scp"),
                         "--workdir", str(workdir), "--steps", "6",
                         "--device", "cpu", "--profile", "--debug-nans"])
    assert len(records(workdir)) == 3
    assert len(list((workdir / "profile").glob("*.pt.trace.json"))) == 1
    assert not torch.is_anomaly_enabled()
