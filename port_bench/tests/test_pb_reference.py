"""The reference against the port's plain path, at a tiny size on the CPU
(the tests may import the port; the reference itself does not)."""

from __future__ import annotations

import numpy as np
import torch

from port_bench import inputs, reference
from port_bench.generators.offline import load_model
from port_bench.generators.train import (
    compare, leaf_norms, reference_batches, reference_numbers)
from port_bench.tests.conftest import tiny_config


def tiny():
    from shallow_wavenet_tpu_torch.config import Config
    cfg = Config.from_dict(tiny_config()["config"])
    mc = tiny_config()["config"]["model"]
    w = inputs.weights(mc, 3, torch.device("cpu"))
    return cfg, mc, w


def test_upsample_is_the_models_to_the_bit():
    cfg, mc, w = tiny()
    model = load_model(cfg, w, "cpu")
    frames = torch.randn(3, 7, mc["aux_channels"])
    with torch.no_grad():
        want = model.upsample_cond(frames)
    assert torch.equal(reference.upsample(w, mc, frames), want)


def test_teacher_forced_samples_meet_the_plain_generator():
    from shallow_wavenet_tpu_torch.models.wavenet import extract_plain_params
    from shallow_wavenet_tpu_torch.ops import ar_kernel
    cfg, mc, w = tiny()
    model = load_model(cfg, w, "cpu")
    frames = torch.randn(2, 9, mc["aux_channels"])
    with torch.no_grad():
        c_up = model.upsample_cond(frames)
    g = torch.Generator().manual_seed(0)
    noise = inputs.uniforms(c_up.shape[:2], g)
    wav = ar_kernel.generate(extract_plain_params(model), cfg.model, c_up,
                             noise=noise, device="cpu")
    for r in range(2):
        gaps = reference.sample_gaps(w, mc, c_up[r], noise[r], wav[r])
        assert float(gaps.max()) < 1e-5
        # the control (TF32 products) reads far wider on the same rows
        ctrl = reference.sample_gaps(w, mc, c_up[r], noise[r], wav[r],
                                     control=True)
        assert float(ctrl.max()) > 100 * max(float(gaps.max()), 1e-7)
    # a sample altered where it is produced is caught
    bad = wav[0].clone()
    bad[5] += 0.01
    assert float(reference.sample_gaps(w, mc, c_up[0], noise[0],
                                       bad).max()) > 5e-3


def test_loss_and_a_group_of_updates_meet_the_trainer():
    """One multi_step call over a group of three updates against the
    reference's three updates: losses, Adam's first moment after the
    group and the change over it."""
    from shallow_wavenet_tpu_torch.training import Trainer
    cfg, mc, w = tiny()
    tc = tiny_config()["config"]["train"]
    trainer = Trainer(cfg, "cpu")
    state = trainer.init_state(tree=inputs.nested_numpy(w))
    start = state.params.clone()
    rng = np.random.default_rng(1)
    T = cfg.data.segment_length + 4 * cfg.data.hop_length
    batches = [(torch.from_numpy(rng.uniform(-0.5, 0.5, (4, T))
                                 .astype(np.float32)),
                torch.from_numpy(rng.standard_normal(
                    (4, T // cfg.data.hop_length, mc["aux_channels"]))
                    .astype(np.float32))) for _ in range(3)]
    state, m = trainer.multi_step(state, {
        "x": torch.stack([x for x, _ in batches]),
        "cond": torch.stack([c for _, c in batches])})
    got = ([float(v) for v in m["loss"]],
           leaf_norms(trainer, state.opt_state["mu"]
                      / (1 - reference.ADAM_B1 ** 3)),
           leaf_norms(trainer, state.params - start))
    ref = reference_numbers(w, mc, tc, cfg.data.segment_length, batches)
    loss_gap, grad_gap, change_gap, _, _ = compare(got, ref)
    assert loss_gap < 1e-4 and grad_gap < 1e-2 and change_gap < 5e-2
    ctrl = compare(reference_numbers(w, mc, tc, cfg.data.segment_length,
                                     batches, reference.fp8), ref)
    assert ctrl[1] > 3 * grad_gap


def test_the_reference_cuts_the_samplers_rows_again():
    """Every row the port's SegmentSampler draws is found in the corpus
    and equals the reference's own cut there, frames included; a row
    whose frames are one frame late is not."""
    from shallow_wavenet_tpu_torch.data.dataset import (
        SegmentSampler, Utterance)
    rng = np.random.default_rng(4)
    hop, seg, n = 4, 64, 5
    wav = np.clip(0.3 * rng.standard_normal((n, 200)), -1, 1).astype(
        np.float32)
    feats = rng.standard_normal((n, 50, 6)).astype(np.float32)
    sampler = SegmentSampler([Utterance(a, f) for a, f in zip(wav, feats)],
                             batch_size=16, segment_length=seg,
                             hop_length=hop, receptive_field=9, seed=3)
    batch = next(sampler)
    group = {"x": batch["x"][None], "cond": batch["cond"][None]}
    cut, off = reference_batches(group, wav, feats, seg, hop)
    assert off == 0 and batch["x"].shape[1] == seg + 12
    assert np.array_equal(cut[0][0], batch["x"])
    assert np.array_equal(cut[0][1], batch["cond"])
    late = {"x": group["x"], "cond": np.roll(group["cond"], 1, axis=2)}
    assert reference_batches(late, wav, feats, seg, hop)[1] == 16
    again = {k: np.concatenate([v, v]) for k, v in group.items()}
    assert reference_batches(again, wav, feats, seg, hop)[1] == 16


def test_block_upsampling_meets_the_whole_utterance():
    """The reference's haloed block upsampling equals upsampling the whole
    utterance (fp32 products: to rounding), and a halo one frame short
    does not."""
    _, mc, w = tiny()
    frames = torch.randn(37, mc["aux_channels"])
    whole = reference.upsample(w, mc, frames[None], reference.fp32)[0]
    blocks = reference.upsample_blocks(w, mc, frames, 16, reference.fp32)
    assert reference.halo(mc["upsample_factors"]) == 2
    assert float((blocks - whole).abs().max()) < 1e-5
    short = reference.halo
    try:
        reference.halo = lambda f: 1
        cut = reference.upsample_blocks(w, mc, frames, 16, reference.fp32)
    finally:
        reference.halo = short
    assert float((cut - whole).abs().max()) > 1e-3


def test_stream_samples_meet_block_upsampling():
    """A pooled stream's samples, teacher-forced through the reference
    with block-upsampled conditioning and the session's uniforms."""
    from shallow_wavenet_tpu_torch.models.streaming import StreamPool
    from shallow_wavenet_tpu_torch.models.wavenet import extract_plain_params
    cfg, mc, w = tiny()
    model = load_model(cfg, w, "cpu")
    pool = StreamPool(extract_plain_params(model), model, cfg.model, 4,
                      slots=1, block_frames=16, device="cpu")
    frames = np.random.default_rng(2).standard_normal(
        (41, mc["aux_channels"])).astype(np.float32)
    sid = pool.open(seed=77)
    pool.push(sid, frames)
    pool.end(sid)
    pieces = []
    while sid in pool.active:
        pieces += [v for k, v in pool.step().items() if k == sid]
    wav = torch.from_numpy(np.concatenate(pieces))
    c_up = reference.upsample_blocks(w, mc, torch.from_numpy(frames), 16)
    u = torch.from_numpy(inputs.stream_uniforms(77, 3, 64))[:len(wav)]
    gaps = reference.sample_gaps(w, mc, c_up[:len(wav)], u, wav)
    assert len(wav) == 41 * 4 and float(gaps.max()) < 1e-5


def tiny_softmax():
    from shallow_wavenet_tpu_torch.config import Config
    from port_bench.tests.conftest import TINY_SOFTMAX
    cfg = Config.from_dict(tiny_config(TINY_SOFTMAX)["config"])
    mc = dict(TINY_SOFTMAX)
    return cfg, mc, inputs.weights(mc, 5, torch.device("cpu"))


def test_the_mulaw_table_is_the_models():
    from shallow_wavenet_tpu_torch.ops.mulaw import (
        mulaw_dequantize, mulaw_quantize)
    got = mulaw_dequantize(torch.arange(256))
    table = reference.mulaw_table(256)
    assert float((got.double() - table).abs().max()) < 1e-7
    ids, off = reference.class_ids(got, 256)
    assert torch.equal(ids, torch.arange(256)) and not off.any()
    # the decode starts from class Q // 2, the class just above 0.0
    assert torch.equal(mulaw_quantize(torch.zeros(1)), torch.tensor([128]))
    assert 0 < float(table[128]) < 1e-4


def _softmax_run():
    from shallow_wavenet_tpu_torch.models.wavenet import extract_plain_params
    from shallow_wavenet_tpu_torch.ops import ar_kernel
    cfg, mc, w = tiny_softmax()
    model = load_model(cfg, w, "cpu")
    frames = torch.randn(2, 11, mc["aux_channels"],
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        c_up = model.upsample_cond(frames)
    noise = inputs.uniforms(c_up.shape[:2], torch.Generator().manual_seed(4))
    wav = ar_kernel.generate(extract_plain_params(model), cfg.model, c_up,
                             noise=noise, device="cpu")
    return mc, w, c_up, noise, wav


def test_the_softmax_judge_meets_the_plain_generator():
    """The port's plain generate, free running on the softmax head: every
    CDF gap at most 1e-6."""
    mc, w, c_up, noise, wav = _softmax_run()
    assert reference.judge(mc) == ("max_cdf_gap", reference.cdf_gaps)
    for r in range(2):
        gaps = reference.cdf_gaps(w, mc, c_up[r], noise[r], wav[r])
        assert gaps.shape == wav[r].shape and float(gaps.max()) <= 1e-6


def test_the_softmax_controls_read_their_class_flips():
    """A control's class differs from the fp32 reference's only where the
    uniform falls between their two CDFs (at a card's sizes, a few hundred
    positions in a million; at this size, none), and reads there the CDFs'
    distance. With each uniform put between the two CDFs at the edge where
    they differ most, every position flips: the TF32 control and the fp8
    upsampler's read that distance, about 1e-5, where the program reads 0
    on its own uniforms."""
    mc, w, c_up, noise, wav = _softmax_run()
    frames = torch.randn(2, 11, mc["aux_channels"],
                         generator=torch.Generator().manual_seed(3))
    c_fp8 = reference.upsample(w, mc, frames, reference.fp8)
    for r, (how, c_low) in enumerate([("tf32", None), ("fp8", c_fp8[1])]):
        ids, _ = reference.class_ids(wav[r], 256)
        x_prev = torch.cat([torch.tensor([128]), ids[:-1]])[None]
        a = reference.softmax_cdf(reference.ar_outputs(
            w, mc, x_prev, c_up[r:r + 1])[0])
        b = reference.softmax_cdf(reference.ar_outputs(
            w, mc, x_prev, c_up[r:r + 1], reference.tf32)[0]
            if how == "tf32" else reference.ar_outputs(
                w, mc, x_prev, c_low[None])[0])
        d = (a - b)[:, :-1].abs()
        k = d.argmax(dim=-1, keepdim=True)
        u = (a.gather(-1, k) + b.gather(-1, k))[:, 0] / 2
        gaps = reference.cdf_gaps(w, mc, c_up[r], u, wav[r],
                                  control=how == "tf32", c_low=c_low)
        assert float(gaps.min()) > 0.4 * float(d.max(dim=-1).values.min())
        assert float(gaps.max()) > 1e-6


def test_a_moved_class_and_an_off_table_sample_are_caught():
    mc, w, c_up, noise, wav = _softmax_run()
    ids, off = reference.class_ids(wav[0], 256)
    assert not off.any()
    t = wav.shape[1] // 2
    # the class at t moved by one, to the side away from its uniform
    cdf = reference.softmax_cdf(reference.ar_outputs(
        w, mc, torch.cat([torch.tensor([128]), ids[:-1]])[None],
        c_up[:1])[0])[t]
    k = int(ids[t])
    lo = float(cdf[k - 1]) if k else 0.0
    step = 1 if float(noise[0, t]) < (lo + float(cdf[k])) / 2 else -1
    moved = wav[0].clone()
    moved[t] = reference.mulaw_table(256)[k + step].float()
    gaps = reference.cdf_gaps(w, mc, c_up[0], noise[0], moved)
    assert float(gaps[t]) >= 1e-3
    # a sample that is no class's value reads 1
    bad = wav[0].clone()
    bad[t] += 3e-5
    assert float(reference.cdf_gaps(w, mc, c_up[0], noise[0],
                                    bad)[t]) == 1.0
