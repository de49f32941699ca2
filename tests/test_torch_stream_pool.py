"""The port's multi-tenant pool (shallow_wavenet_tpu_torch.models.streaming
.StreamPool) on the CPU, where it runs the AR kernel's plain version: the
ports of tests/test_streaming.py's pool tests (:144 staggered streams over
two slots, :200 tails, :245 the softmax head, :273 lifecycle errors) and
the fused window.

Each pooled stream is held against a standalone batch=1 port session with
the same seed fed the same frames: the pool's rows are the sessions' own
(conditioning, uniforms, teacher). A step upsamples every member's haloed
window in one call, each window's products at its own shape, so each
member's conditioning equals its window upsampled alone, to the bit. Where every launch has one row, to the
bit. Where streams share a launch, at atol TOL_ROWS = 1e-6: the plain
version's products of one row and of k rows go through different CPU GEMM
paths (a matrix-vector product against a matrix product), which may round
a sum one ulp apart (measured: 1.2e-7 on 8% of a Laplace stream's
samples; on the card the kernel's rows are independent of the batch, and
chip_smoke.py holds the pool to the bit there). The softmax head's
class ids absorb that rounding and are held to the bit. Not against the
JAX pool: its
sessions force each warm-up step one sample late (ROADMAP Queue C, pinned
by tests/test_torch_streaming.py). One pooled stream is held instead
against the JAX batch call over that stream's own conditioning and
uniforms (generate_pallas in interpret mode), at atol 1e-5 as in
tests/test_torch_streaming.py (the two packages' upsamplers and AR paths
sum in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.models import extract_plain_params as jax_plain
from shallow_wavenet_tpu.ops.ar_kernel import generate_pallas
from shallow_wavenet_tpu_torch.models.streaming import (
    StreamingSynthesizer, StreamPool,
)
from shallow_wavenet_tpu_torch.models.wavenet import extract_plain_params
from shallow_wavenet_tpu_torch.ops import ar_kernel

from tests.test_torch_generate import assert_same_samples
from tests.test_torch_model import port_cfg
from tests.test_torch_streaming import _setup

BLOCK = 32
TOL_ROWS = 1e-6


def _pool(model, cfg, hop, slots=2, block_frames=BLOCK, **kw):
    return StreamPool(extract_plain_params(model), model, port_cfg(cfg),
                      hop_length=hop, slots=slots, block_frames=block_frames,
                      chunk=64, device="cpu", **kw)


def _standalone(model, cfg, hop, frames, seed, **kw):
    """Oracle: a batch=1 session fed the whole stream at once."""
    syn = StreamingSynthesizer(extract_plain_params(model), model,
                               port_cfg(cfg), hop_length=hop, batch=1,
                               block_frames=BLOCK, chunk=64, seed=seed,
                               device="cpu", **kw)
    return np.concatenate([syn.push(frames[None]), syn.flush()], axis=1)[0]


def _drain(pool, got, name_of, max_steps=50):
    """Step until every stream is closed; at most two launches a step."""
    for _ in range(max_steps):
        if not pool.active:
            return
        before = pool.dispatches
        for sid, w in pool.step().items():
            got[name_of[sid]].append(w)
        assert pool.dispatches - before <= 2
    raise AssertionError("streams still open")


def _frames(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((n, cfg.aux_channels)).astype(np.float32)
            for k, n in lens.items()}


def test_pool_streams_match_standalone_sessions():
    """tests/test_streaming.py:144: three streams of different lengths
    share two slots (b joins mid-flight, c reuses a's slot); each equals
    its standalone session, and a's block and b's first block share one
    step in two launches (a warm-started, b first)."""
    cfg, m, v, model, _, hop = _setup("laplace", F=4)
    fr = _frames(cfg, {"a": 100, "b": 80, "c": 70}, 42)
    seeds = {"a": 11, "b": 22, "c": 33}
    pool = _pool(model, cfg, hop)
    got = {k: [] for k in fr}
    sid = {"a": pool.open(seed=seeds["a"])}
    name_of = {sid["a"]: "a"}
    pool.push(sid["a"], fr["a"][:50])
    got["a"].append(pool.step()[sid["a"]])          # a: first block
    assert pool.dispatches == 1
    sid["b"] = pool.open(seed=seeds["b"])
    name_of[sid["b"]] = "b"
    pool.push(sid["b"], fr["b"][:40])
    pool.push(sid["a"], fr["a"][50:])
    shared = pool.step()                            # a mid + b first
    assert set(shared) == {sid["a"], sid["b"]} and pool.dispatches == 3
    for s, w in shared.items():
        got[name_of[s]].append(w)
    pool.end(sid["a"])
    assert pool.free_slots == 0
    with pytest.raises(RuntimeError, match="slots busy"):
        pool.open(seed=9)
    while sid["a"] in pool.active:                  # a's tail; slot frees
        for s, w in pool.step().items():
            got[name_of[s]].append(w)
    assert pool.free_slots == 1
    sid["c"] = pool.open(seed=seeds["c"])
    name_of[sid["c"]] = "c"
    pool.push(sid["c"], fr["c"])
    pool.push(sid["b"], fr["b"][40:])
    assert pool.pending_frames(sid["c"]) == 70
    pool.end(sid["b"])
    pool.end(sid["c"])
    _drain(pool, got, name_of)
    assert not pool.active and pool.free_slots == 2
    for k in fr:
        wav = np.concatenate(got[k])
        oracle = _standalone(model, cfg, hop, fr[k], seeds[k])
        assert wav.shape == oracle.shape == (fr[k].shape[0] * hop,)
        np.testing.assert_allclose(wav, oracle, rtol=0, atol=TOL_ROWS)


def test_pool_tails_ride_pooled_launches(monkeypatch):
    """tests/test_streaming.py:200: an ended stream's partial last block
    (97 frames: two whole blocks and 33 left, more than a block and less
    than a block plus the halo, so two tail cycles), and a stream that
    ends before its first whole block (20 frames), ride the pooled
    launches, never a session's flush; at most two launches a step, and
    the plain version launches no kernel."""
    cfg, m, v, model, _, hop = _setup("laplace", F=4)
    fr = _frames(cfg, {"a": 97, "b": 70, "c": 20}, 7)
    oracles = {k: _standalone(model, cfg, hop, fr[k], 60 + i)
               for i, k in enumerate(fr)}
    pool = _pool(model, cfg, hop, slots=3)
    assert pool.halo == 2
    sid = {k: pool.open(seed=60 + i) for i, k in enumerate(fr)}
    for k in fr:
        pool.push(sid[k], fr[k])
        pool.end(sid[k])

    def boom(self):
        raise AssertionError("a session's flush used for a pooled tail")

    monkeypatch.setattr(StreamingSynthesizer, "flush", boom)
    ar_kernel.launches.clear()
    got = {k: [] for k in fr}
    _drain(pool, got, {v_: k for k, v_ in sid.items()})
    assert not ar_kernel.launches
    # steps: (a, b, c first) | (a, b) | (a tail 33 of 32, b tail) | a's 1
    assert pool.dispatches == 4
    for k in fr:
        wav = np.concatenate(got[k])
        assert wav.shape == (fr[k].shape[0] * hop,)
        np.testing.assert_allclose(wav, oracles[k], rtol=0, atol=TOL_ROWS)


def test_pool_softmax_matches_standalone():
    """tests/test_streaming.py:245: the warm-start's mu-law teacher."""
    cfg, m, v, model, _, hop = _setup("softmax", F=4)
    fr = _frames(cfg, {"a": 80, "b": 70}, 5)
    pool = _pool(model, cfg, hop)
    sid = {k: pool.open(seed=40 + i) for i, k in enumerate(fr)}
    for k in fr:
        pool.push(sid[k], fr[k])
        pool.end(sid[k])
    got = {k: [] for k in fr}
    _drain(pool, got, {v_: k for k, v_ in sid.items()})
    for i, k in enumerate(fr):
        np.testing.assert_array_equal(
            np.concatenate(got[k]),
            _standalone(model, cfg, hop, fr[k], 40 + i))


def test_pool_fused_window_matches_standalone():
    """fused=4 on the pool and on the standalone sessions, staggered."""
    cfg, m, v, model, _, hop = _setup("laplace", F=4)
    fr = _frames(cfg, {"a": 90, "b": 75}, 9)
    pool = _pool(model, cfg, hop, fused=4)
    got = {k: [] for k in fr}
    sid = {"a": pool.open(seed=1)}
    pool.push(sid["a"], fr["a"][:60])
    got["a"].append(pool.step()[sid["a"]])
    sid["b"] = pool.open(seed=2)
    name_of = {v_: k for k, v_ in sid.items()}
    for k, lo in (("a", 60), ("b", 0)):
        pool.push(sid[k], fr[k][lo:])
        pool.end(sid[k])
    _drain(pool, got, name_of)
    for k, seed in (("a", 1), ("b", 2)):
        np.testing.assert_allclose(
            np.concatenate(got[k]),
            _standalone(model, cfg, hop, fr[k], seed, fused=4), rtol=0,
            atol=TOL_ROWS)


@pytest.mark.parametrize("fused", [0, 4])
def test_pool_alone_equals_session_to_the_bit(fused):
    """One stream at a time through the pool, pushed in ragged pieces and
    ended mid-block: every launch has its one row, and the stream equals
    its standalone session to the bit (the pool's blocks, uniforms,
    teacher and history are the session's)."""
    cfg, m, v, model, _, hop = _setup("laplace", F=4)
    fr = _frames(cfg, {"a": 83, "b": 45}, 11)
    pool = _pool(model, cfg, hop, slots=1, fused=fused)
    for k, seed in (("a", 3), ("b", 4)):
        sid = pool.open(seed=seed)
        got = []
        for lo in range(0, len(fr[k]), 13):
            pool.push(sid, fr[k][lo:lo + 13])
            got += list(pool.step().values())
        pool.end(sid)
        while pool.active:
            got += list(pool.step().values())
        np.testing.assert_array_equal(
            np.concatenate(got),
            _standalone(model, cfg, hop, fr[k], seed, fused=fused))


def test_pooled_stream_matches_jax_batch_call():
    """One pooled stream (beside another) against the JAX batch call over
    its own conditioning and uniforms."""
    cfg, m, v, model, _, hop = _setup("laplace", F=4)
    fr = _frames(cfg, {"a": 85, "b": 64}, 3)
    pool = _pool(model, cfg, hop, record_noise=True)
    sid = {k: pool.open(seed=5 + i) for i, k in enumerate(fr)}
    syn = pool.session(sid["a"])
    for k in fr:
        pool.push(sid[k], fr[k])
        pool.end(sid[k])
    got = {k: [] for k in fr}
    _drain(pool, got, {v_: k for k, v_ in sid.items()})
    wav = np.concatenate(got["a"])
    c_up, noise = syn.cond_so_far(), syn.noise_so_far()
    assert c_up.shape == (1, 85 * hop, cfg.cond_channels)
    jbatch = np.asarray(generate_pallas(
        jax_plain(v, cfg), cfg, jnp.asarray(c_up.numpy()),
        noise=jnp.asarray(noise.numpy()), chunk=64, interpret=True))
    assert_same_samples(cfg, wav[None], jbatch)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_one_upsampler_call_a_step(k, monkeypatch):
    """A step over k members upsamples every member's haloed window in
    one upsampler call (counted by `upsample_calls`, `upsample_windows`),
    whatever the mix of first and warm-started blocks."""
    cfg, m, v, model, _, hop = _setup("laplace", F=4)
    fr = _frames(cfg, {i: 3 * BLOCK for i in range(k)}, 13)
    pool = _pool(model, cfg, hop, slots=k)
    sids = [pool.open(seed=i) for i in range(k)]
    calls = []
    real = model.upsample_cond

    def counted(cond, *a, **kw):
        calls.append(tuple(cond.shape))
        return real(cond, *a, **kw)

    monkeypatch.setattr(model, "upsample_cond", counted)
    for i, sid in enumerate(sids):       # the first stream one block ahead
        pool.push(sid, fr[i][:2 * BLOCK + 2 if i == 0 else BLOCK + 2])
    assert len(pool.step()) == k
    assert (pool.upsample_calls, pool.upsample_windows) == (1, k)
    assert calls == [(k, BLOCK + 2, cfg.aux_channels)]
    for i, sid in enumerate(sids):
        pool.push(sid, fr[i][2 * BLOCK + 2 if i == 0 else BLOCK + 2:])
        pool.end(sid)
    steps = 1
    while pool.active:
        before = pool.upsample_windows
        emitted = pool.step()
        steps += bool(emitted)
        assert pool.upsample_windows - before == len(emitted)
    assert pool.upsample_calls == len(calls) == steps
    assert pool.upsample_windows == 3 * k


def test_mixed_step_gives_each_member_its_windows_rows(monkeypatch):
    """One step over a first block, a middle block and a short tail block
    (windows of 34, 36 and 9 frames, one upsampler call): each member's
    conditioning rows equal, to the bit, its session's single haloed
    window upsampled alone (the model's `upsample_cond` on that window,
    trimmed and padded to a whole block)."""
    cfg, m, v, model, _, hop = _setup("laplace", F=4,
                                      compute_dtype="bfloat16")
    fr = _frames(cfg, {"mid": 2 * BLOCK + 2, "first": BLOCK + 2,
                       "tail": BLOCK + 7}, 17)
    pool = _pool(model, cfg, hop, slots=3)
    sid = {"mid": pool.open(seed=1), "tail": pool.open(seed=2)}
    for k in sid:
        pool.push(sid[k], fr[k])
    pool.end(sid["tail"])
    assert set(pool.step()) == set(sid.values())     # both first blocks
    sid["first"] = pool.open(seed=3)
    pool.push(sid["first"], fr["first"])
    want = {}
    for k, i in sid.items():
        s = pool.session(i)
        n, win, trim = s._next_window(last=k == "tail")
        with torch.no_grad():
            c_up = model.upsample_cond(torch.from_numpy(win.copy()))
        c_up = c_up[:, trim:trim + n * hop]
        want[i] = torch.nn.functional.pad(
            c_up, (0, 0, 0, BLOCK * hop - c_up.shape[1]))
        assert win.shape[1] == {"mid": BLOCK + 4, "first": BLOCK + 2,
                                "tail": 9}[k]
    got = {}
    prepare = StreamingSynthesizer._prepare_block

    def record(self, c_blk):
        got[self.sid] = c_blk
        return prepare(self, c_blk)

    monkeypatch.setattr(StreamingSynthesizer, "_prepare_block", record)
    calls = (pool.upsample_calls, pool.upsample_windows)
    assert set(pool.step()) == set(sid.values())
    assert (pool.upsample_calls, pool.upsample_windows) == (
        calls[0] + 1, calls[1] + 3)
    assert pool.dispatches == 3                      # first | warm-started
    for i in sid.values():
        assert torch.equal(got[i], want[i])


def test_pool_lifecycle_errors():
    """tests/test_streaming.py:273, with the width check naming the
    stream."""
    cfg, m, v, model, _, hop = _setup("laplace", F=4)
    pool = _pool(model, cfg, hop, slots=1)
    a = pool.open(seed=0)
    pool.end(a)
    with pytest.raises(RuntimeError, match="already ended"):
        pool.push(a, np.zeros((3, cfg.aux_channels), np.float32))
    assert pool.step() == {}                   # empty ended stream closes
    assert not pool.active and pool.dispatches == 0
    with pytest.raises(KeyError):
        pool.push(a, np.zeros((3, cfg.aux_channels), np.float32))
    b = pool.open(seed=1)                      # slot was freed
    with pytest.raises(ValueError, match=r"\(n, aux\)"):
        pool.push(b, np.zeros((2, 3, cfg.aux_channels), np.float32))
    with pytest.raises(ValueError, match=f"stream {b}: expected aux width"):
        pool.push(b, np.zeros((3, cfg.aux_channels + 1), np.float32))
    assert pool.pending_frames(b) == 0 and pool.clusters_at_once is None
    with pytest.raises(ValueError, match="multiple of chunk"):
        _pool(model, cfg, hop, block_frames=2)


def test_pool_raises_without_cuda(monkeypatch):
    """device=None means CUDA."""
    cfg, m, v, model, _, hop = _setup("laplace", F=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamPool(extract_plain_params(model), model, port_cfg(cfg),
                   hop_length=hop)
