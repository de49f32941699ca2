"""The traffic generators repeat from the seed and give every seed the
same work; the live schedule's due times."""

from __future__ import annotations

import numpy as np
import torch

from port_bench import harness, inputs
from port_bench.generators import live, offline


def test_offline_batches_repeat_from_the_seed():
    mix = harness.load_json(harness.ROOT, "mixes", "offline_b8")
    mc = {"aux_channels": 80}
    a = offline.Batches(2 ** 31 + 7, mix, mc, 320, torch.device("cpu"))
    b = offline.Batches(2 ** 31 + 7, mix, mc, 320, torch.device("cpu"))
    c = offline.Batches(5, mix, mc, 320, torch.device("cpu"))
    (ua, na), (ub, nb), (uc, _) = a.get(3), b.get(3), c.get(3)
    assert all(np.array_equal(x.feats, y.feats) for x, y in zip(ua, ub))
    assert torch.equal(na, nb)
    assert not np.array_equal(ua[0].feats, uc[0].feats)
    # every seed and batch holds the same frame counts, in another order
    for u in (ua, uc, a.get(0)[0]):
        assert sorted(x.feats.shape[0] for x in u) == sorted(mix["frames"])
    assert float(na.min()) >= 1e-7 and float(na.max()) <= 1 - 1e-7


def test_live_callers_offer_every_seed_the_same_schedule():
    mix = harness.load_json(harness.ROOT, "mixes", "live_streams")
    n = mix["streams"]
    one = [live.Caller(c, n, 99, mix, 24000, 320, 0.0) for c in range(n)]
    two = [live.Caller(c, n, 99, mix, 24000, 320, 0.0) for c in range(n)]
    other = [live.Caller(c, n, 5, mix, 24000, 320, 0.0) for c in range(n)]
    for x, y, z in zip(one, two, other):
        fx, sx = x.utterance(80)
        fy, sy = y.utterance(80)
        fz, sz = z.utterance(80)
        assert np.array_equal(fx, fy) and sx == sy
        assert fx.shape == fz.shape and not np.array_equal(fx, fz)
        assert np.array_equal(x.lengths, z.lengths)
        assert np.array_equal(x.pauses, z.pauses)
        assert sorted(x.lengths) == sorted(mix["utt_seconds"])
        assert sorted(x.pauses) == sorted(mix["pause_seconds"])
    assert not np.array_equal(one[0].lengths, one[1].lengths)


def test_block_due_times():
    # 20 frames, blocks of 6, halo 2: block 0 needs frames 0..7 (push 1),
    # block 1 frames ..13 (push 2), block 2 ..19 = the end (push 3),
    # block 3, the partial tail, the end
    due = live.block_due(10.0, 20, 6, 2, 0.08)
    assert np.allclose(due, [10.08, 10.16, 10.24, 10.24])
    assert live.block_due(0.0, 18, 6, 2, 0.08) == live.block_due(
        0.0, 18, 6, 2, 0.08)
    assert np.allclose(live.block_due(0.0, 18, 6, 2, 0.08), [0.08, 0.16,
                                                            0.16])


def test_stream_uniforms_are_the_sessions():
    """`inputs.stream_uniforms` is the draw a pooled stream consumes."""
    from shallow_wavenet_tpu_torch.config import ModelConfig
    from shallow_wavenet_tpu_torch.models.streaming import StreamPool
    from shallow_wavenet_tpu_torch.models.wavenet import (
        WaveNet, extract_plain_params)
    mc = ModelConfig(n_stacks=1, stack_size=3, residual_channels=8,
                     gate_channels=16, skip_channels=16, aux_channels=6,
                     upsample_factors=(2, 2), cond_channels=8)
    model = WaveNet(mc)
    pool = StreamPool(extract_plain_params(model), model, mc, 4, slots=1,
                      block_frames=16, record_noise=True, device="cpu")
    sid = pool.open(seed=1234)
    pool.push(sid, np.random.default_rng(0).standard_normal(
        (40, 6)).astype(np.float32))
    pool.end(sid)
    s = pool.session(sid)
    while sid in pool.active:
        pool.step()
    got = s.noise_so_far()[0].numpy()
    want = inputs.stream_uniforms(1234, 3, 64)[:len(got)]
    assert np.array_equal(got, want)


def test_seed_streams_are_distinct_and_take_large_seeds():
    a = inputs.seed_of(2 ** 31 + 11, "weights")
    b = inputs.seed_of(2 ** 31 + 11, "traffic")
    assert a != b and 0 <= a < 2 ** 63
    assert inputs.seed_of(2 ** 31 + 11, "traffic", 4) == inputs.seed_of(
        2 ** 31 + 11, "traffic", 4)
