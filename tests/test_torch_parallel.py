"""Data parallelism in the port (shallow_wavenet_tpu_torch.parallel) on the
CPU: the ports of tests/test_parallel.py, tests/test_multiprocess.py and
tests/test_recipe.py::test_decode_dp_cli.

Training runs over 2 gloo ranks spawned once for the module
(tests/torch_dp_worker.py, joined through the launcher's variables as
`torchrun` sets them), at tests/test_train.py::tiny_train_cfg shapes; the
single-process reference is the port's own Trainer on the global batch,
the row concatenation of the ranks' batches (`ConcatSampler`), and the
first update also the JAX Trainer's `step_fn` on it, from one flax init.

Tolerances. The mean of the ranks' gradients equals the gradient of the
global batch in exact arithmetic; in fp32 the sums run in another order,
so the loss is held at rtol 1e-5 and the grad norm at rtol 1e-4, the JAX
suite's (test_parallel.py:38), the parameters after 3 updates within 1e-6
of the single-process run, and the logged losses of a 12-update `fit`
within atol 5e-5 of the reference's, the JAX multi-process suite's
(test_multiprocess.py). Between ranks, and between a resumed run and a
straight one, the same bits.

Then the train CLI's mesh rule without a launcher (C2), the refusals, and
the split decode: `generate_dp` over two host "devices" with a padded
batch, and `decode --dp`, both against the single call to the bit.
"""

import dataclasses
import json
import logging
import socket
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from shallow_wavenet_tpu.config import Config as JaxConfig
from shallow_wavenet_tpu.training import Trainer as JaxTrainer
from shallow_wavenet_tpu_torch.bin import decode, train
from shallow_wavenet_tpu_torch.config import MeshConfig
from shallow_wavenet_tpu_torch.data.dataset import (
    Utterance, pad_batch_for_decode,
)
from shallow_wavenet_tpu_torch.models.generate import generate_dp
from shallow_wavenet_tpu_torch.models.wavenet import (
    WaveNet, extract_plain_params, init_params_tree, params_from_flax,
    save_params_npz,
)
from shallow_wavenet_tpu_torch.ops import ar_kernel
from shallow_wavenet_tpu_torch.parallel import (
    dp_devices, init_distributed, mesh, process_shard,
)
from shallow_wavenet_tpu_torch.training import Trainer

from tests import torch_dp_worker as w
from tests.test_model import randomize_head
from tests.test_torch_train_loop import _corpus, records, tiny_train_cfg

SPAWN_TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, args, nprocs: int, timeout: float = SPAWN_TIMEOUT) -> None:
    """Run fn(rank, *args) in `nprocs` spawned processes. A rank that
    raises fails the call (and the others are ended); so does a run past
    `timeout` seconds."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The 2-rank run, and everything the tests compare it with."""
    out = tmp_path_factory.mktemp("dp")
    cfg = w.step_cfg()
    jt = JaxTrainer(JaxConfig.from_dict(cfg.to_dict()))
    init = jt.init_state()
    warm = randomize_head({"params": init.params}, seed=5)["params"]
    tree = jax.tree.map(np.asarray, warm)
    save_params_npz(out / "tree.npz", tree)
    ccfg = tiny_train_cfg(checkpoint_every=4, log_every=2)
    ccfg.data = dataclasses.replace(ccfg.data, segment_length=400)
    (out / "corpus").mkdir()
    (out / "corpus/config.json").write_text(ccfg.to_json())
    _corpus(out / "corpus", ccfg)

    spawn(w.run, (w.N_RANKS, _free_port(), str(out)), w.N_RANKS)
    ranks = [(dict(np.load(out / f"rank{r}.npz")),
              json.loads((out / f"rank{r}.json").read_text()))
             for r in range(w.N_RANKS)]

    # the references: the port's Trainer on the global batches, and the
    # JAX Trainer's first update
    utts = w.utterances(cfg)
    gcfg = w.step_cfg(w.STEP_B * w.N_RANKS)
    glob = w.ConcatSampler(cfg, utts)
    batches = [next(glob) for _ in range(w.DP_STEPS)]
    tr = Trainer(gcfg, "cpu")
    s, single = tr.init_state(tree=tree), []
    for b in batches:
        s, m = tr.step(s, b)
        single.append((float(m["loss"]), float(m["grad_norm"])))
    # the same with context dropout: one mask per row of the global batch
    dcfg = w.step_cfg(w.STEP_B * w.N_RANKS, **w.DROPOUT)
    dglob = w.ConcatSampler(w.step_cfg(**w.DROPOUT), utts)
    dtr = Trainer(dcfg, "cpu")
    ds, drop = dtr.init_state(tree=tree), []
    for _ in range(w.DROP_STEPS):
        ds, m = dtr.step(ds, next(dglob))
        drop.append((float(m["loss"]), float(m["grad_norm"])))
    ones = torch.ones(w.STEP_B * w.N_RANKS, dcfg.data.segment_length)
    drop_mask = dtr._context_dropout(ones, dtr._dropout_generator(0, 0))
    gjt = JaxTrainer(JaxConfig.from_dict(gcfg.to_dict()))
    _, jm = gjt.step_fn(init.replace(params=warm),
                        gjt.shard_batch(batches[0]))
    return {"out": out, "ranks": ranks, "single": np.array(single),
            "single_params": s.params.numpy(),
            "drop": np.array(drop), "drop_params": ds.params.numpy(),
            "drop_mask": drop_mask.numpy(),
            "jax_first": (float(jm["loss"]), float(jm["grad_norm"])),
            "tree": tree, "utts": utts}


def test_ranks_joined_as_launched(dp_run):
    for arrays, facts in dp_run["ranks"]:
        assert facts["dp"] is True
        assert "smaller than the launched world of 2" in (
            facts["num_devices_refused"])


def test_dp_step_matches_single_process_and_jax(dp_run):
    """tests/test_parallel.py:38: the 2-rank step's loss and grad norm
    equal the single-process step's on the global batch, and the JAX
    Trainer's; the parameters after 3 updates are one set of bits on
    every rank, within 1e-6 of the single-process run's."""
    (a0, _), (a1, _) = dp_run["ranks"]
    single = dp_run["single"]
    for arrays in (a0, a1):
        m = arrays["step_metrics"]
        np.testing.assert_allclose(m[:, 0], single[:, 0], rtol=1e-5)
        np.testing.assert_allclose(m[:, 1], single[:, 1], rtol=1e-4)
        jl, jg = dp_run["jax_first"]
        np.testing.assert_allclose(m[0, 0], jl, rtol=1e-5)
        np.testing.assert_allclose(m[0, 1], jg, rtol=1e-4)
    assert np.array_equal(a0["step_metrics"], a1["step_metrics"])
    assert np.array_equal(a0["step_params"], a1["step_params"])
    np.testing.assert_allclose(a0["step_params"], dp_run["single_params"],
                               rtol=0, atol=1e-6)


def test_dp_context_dropout_masks_each_global_row(dp_run):
    """With context dropout, each rank masks its rows with its own rows of
    the global batch's mask, so the ranks' masks differ and the 2-rank
    updates equal the single-process ones on the global batch, at the
    tolerances above."""
    (a0, _), (a1, _) = dp_run["ranks"]
    m0, m1 = a0["drop_mask"], a1["drop_mask"]
    assert 0 < m0.mean() < 1 and not np.array_equal(m0, m1)
    assert np.array_equal(np.concatenate([m0, m1]), dp_run["drop_mask"])
    for arrays in (a0, a1):
        m = arrays["drop_metrics"]
        np.testing.assert_allclose(m[:, 0], dp_run["drop"][:, 0], rtol=1e-5)
        np.testing.assert_allclose(m[:, 1], dp_run["drop"][:, 1], rtol=1e-4)
    assert np.array_equal(a0["drop_params"], a1["drop_params"])
    np.testing.assert_allclose(a0["drop_params"], dp_run["drop_params"],
                               rtol=0, atol=1e-6)
    # the loss sees the mask: it is not the undropped update's
    assert not np.allclose(dp_run["drop"][0, 0], dp_run["single"][0, 0],
                           rtol=1e-5)


def test_dp_training_runs_and_decreases(dp_run):
    """tests/test_parallel.py:62: 30 updates over 2 ranks; the loss falls,
    rank 0 alone writes the records, and the parameters are the same
    bits on both ranks."""
    (a0, _), (a1, _) = dp_run["ranks"]
    recs = records(dp_run["out"] / "fit30")
    assert [r["step"] for r in recs] == [10, 20, 30]
    assert recs[-1]["loss"] < recs[0]["loss"]
    assert np.array_equal(a0["fit30_params"], a1["fit30_params"])
    assert sorted(p.name for p in
                  (dp_run["out"] / "fit30/checkpoints").iterdir()) == ["30"]


def test_dp_grad_accum_matches_plain_dp(dp_run):
    """tests/test_parallel.py:129: grad_accum = 2 inside each rank, then
    one reduce, equals the plain DP update."""
    for arrays, _ in dp_run["ranks"]:
        np.testing.assert_allclose(arrays["accum_loss"],
                                   arrays["plain_loss"], rtol=1e-5)
        np.testing.assert_allclose(arrays["accum_params"],
                                   arrays["plain_params"], rtol=2e-5,
                                   atol=2e-6)
    (a0, _), (a1, _) = dp_run["ranks"]
    assert np.array_equal(a0["accum_params"], a1["accum_params"])


def test_dp_fit_multi_step_resumes_exactly(dp_run):
    """tests/test_multiprocess.py:44, short: `fit` at steps_per_call = 4
    over 2 ranks; stopped at its step-8 checkpoint and resumed, each rank
    ends on the straight run's bits, with its own sampler state; the
    logged losses track the single-process run on the ConcatSampler."""
    out = dp_run["out"]
    states = json.loads((out / "resumed/checkpoints/8/state.json"
                         ).read_text())["sampler"]["ranks"]
    assert len(states) == w.N_RANKS and states[0] != states[1]
    for r, (arrays, facts) in enumerate(dp_run["ranks"]):
        assert facts["restored_step"] == w.RESUME_AT
        assert facts["restored_sampler"] == states[r]
        assert np.array_equal(arrays["resumed_params"],
                              arrays["straight_params"])
    a, b = records(out / "straight"), records(out / "resumed")
    assert ([(r["step"], r["loss"], r["grad_norm"]) for r in a]
            == [(r["step"], r["loss"], r["grad_norm"]) for r in b])
    # a call of K updates logs once
    assert [r["step"] for r in a] == list(range(w.K, w.RESUME_TO + 1, w.K))

    gcfg = w.resume_cfg(w.FIT_B * w.N_RANKS)
    tr = Trainer(gcfg, "cpu")
    ref = out / "reference"
    tr.fit(tr.init_state(tree=dp_run["tree"]),
           w.ConcatSampler(w.resume_cfg(), dp_run["utts"]), ref,
           steps=w.RESUME_TO)
    want = records(ref)
    np.testing.assert_allclose([r["loss"] for r in a],
                               [r["loss"] for r in want], rtol=0, atol=5e-5)
    # samples_per_s counts the global batch on both
    assert a[-1]["samples_per_s"] > 0


def test_dp_train_cli_under_the_launcher(dp_run):
    """bin.train under the launcher's variables: each rank trains on its
    shard, rank 0 writes the records and checkpoints, and each
    checkpoint keeps both ranks' sampler states."""
    cli = dp_run["out"] / "cli"
    recs = records(cli)
    assert [r["step"] for r in recs] == [2, 4, 6]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert "eval_loss" in recs[1]
    meta = json.loads((cli / "checkpoints/6/state.json").read_text())
    assert meta["step"] == 6 and len(meta["sampler"]["ranks"]) == 2


@pytest.mark.parametrize("override", ["mesh.multihost=true",
                                      "mesh.num_devices=2"])
def test_train_cli_mesh_without_launcher(tmp_path, caplog, override):
    """C2: without launcher variables, a mesh that asks for more than one
    device trains as one process on the one device, with one warning, and
    writes the default run's losses."""
    cfg = tiny_train_cfg(checkpoint_every=4, log_every=2)
    cfg.data = dataclasses.replace(cfg.data, segment_length=400)
    (tmp_path / "config.json").write_text(cfg.to_json())
    feats = _corpus(tmp_path, cfg)
    common = ["--config", str(tmp_path / "config.json"),
              "--feats-dir", str(feats), "--stats", str(tmp_path / "stats.h5"),
              "--train-scp", str(tmp_path / "corpus/train.scp"),
              "--steps", "4", "--device", "cpu"]
    train.main(common + ["--workdir", str(tmp_path / "default")])
    with caplog.at_level(logging.WARNING):
        train.main(common + ["--workdir", str(tmp_path / "mesh"), override])
    warned = [r for r in caplog.records
              if "no launcher variable" in r.getMessage()]
    assert len(warned) == 1
    got, want = records(tmp_path / "mesh"), records(tmp_path / "default")
    assert ([(r["step"], r["loss"]) for r in got]
            == [(r["step"], r["loss"]) for r in want])
    assert not torch.distributed.is_initialized()


def test_configured_launch_that_fails_raises(monkeypatch):
    """A launcher variable set and no group to be had: raise, never go on
    as one process."""
    for v in mesh.LAUNCHER_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="refusing to continue"):
        init_distributed(MeshConfig(), "cpu")
    assert not torch.distributed.is_initialized()


def test_one_process_helpers(monkeypatch):
    for v in mesh.LAUNCHER_VARS:
        monkeypatch.delenv(v, raising=False)
    assert init_distributed(MeshConfig(num_devices=4), "cpu").type == "cpu"
    assert (mesh.rank(), mesh.world(), mesh.is_main()) == (0, 1, True)
    assert process_shard([1, 2, 3]) == [1, 2, 3]
    t = torch.arange(3.0)
    assert mesh.all_reduce_mean(t) is t and t.tolist() == [0.0, 1.0, 2.0]
    # num_devices caps the decode's split; the host stands in for them
    assert dp_devices(MeshConfig(), "cpu") == [torch.device("cpu")]
    assert dp_devices(MeshConfig(num_devices=3), "cpu") == \
        [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="needs a process group"):
        Trainer(tiny_train_cfg(), "cpu", dp=True)


def test_entry_points_raise_without_cuda(monkeypatch):
    """device=None means CUDA (tests/test_torch_train_loop.py's
    pattern)."""
    for v in mesh.LAUNCHER_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed(MeshConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dp_devices(MeshConfig())
    cfg, model, _ = _decode_setup(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_dp(extract_plain_params(model), cfg.model,
                    torch.zeros(2, 8, cfg.model.cond_channels),
                    torch.full((2, 8), 0.5))


def _decode_setup(n_utts: int, seed: int = 0):
    """tiny_train_cfg's model with the port's init and a random head2, and
    n_utts utterances of 5..9 random normalized frames."""
    cfg = tiny_train_cfg()
    tree = init_params_tree(cfg.model, seed)
    rng = np.random.default_rng(seed + 1)
    tree["head2"]["kernel"] = (0.05 * rng.standard_normal(
        tree["head2"]["kernel"].shape)).astype(np.float32)
    model = params_from_flax(WaveNet(cfg.model), tree)
    utts = [Utterance(np.zeros(0, np.float32), rng.standard_normal(
        (int(rng.integers(5, 10)), cfg.model.aux_channels)
    ).astype(np.float32)) for _ in range(n_utts)]
    return cfg, model, utts


def test_generate_dp_matches_single_call():
    """The rows split over two host 'devices' equal the single call on the
    same noise, to the bit (the plain version's rows do not depend on the
    batch here); a batch that does not split raises."""
    cfg, model, utts = _decode_setup(4)
    cond, _, _ = pad_batch_for_decode(utts, cfg.data.hop_length)
    with torch.no_grad():
        c_up = model.upsample_cond(torch.from_numpy(cond))
    pp = extract_plain_params(model)
    noise = ar_kernel.uniform_noise(c_up.shape[:2],
                                    torch.Generator().manual_seed(3))
    one = ar_kernel.generate(pp, cfg.model, c_up, noise=noise, device="cpu")
    split = generate_dp(pp, cfg.model, c_up, noise, ["cpu", "cpu"])
    assert split.device.type == "cpu" and split.shape == one.shape
    assert torch.equal(split, one)
    with pytest.raises(ValueError, match="does not split"):
        generate_dp(pp, cfg.model, c_up[:3], noise[:3], ["cpu", "cpu"])


def test_decode_batch_dp_pads_and_trims():
    """decode_batch with devices: 3 utterances padded to 4 rows over two
    host devices, trimmed back, equal to the single-device decode with
    the same generator."""
    cfg, model, utts = _decode_setup(3)
    want = decode.decode_batch(model, cfg, utts,
                               generator=torch.Generator().manual_seed(7),
                               device="cpu")
    got = decode.decode_batch(model, cfg, utts,
                              generator=torch.Generator().manual_seed(7),
                              device="cpu", devices=["cpu", "cpu"])
    assert len(got) == 3
    for g, x in zip(got, want):
        assert np.array_equal(g, x)
    with pytest.raises(ValueError, match="mutually exclusive"):
        decode.decode_batch(model, cfg, utts, generator=torch.Generator(),
                            device="cpu", devices=["cpu", "cpu"],
                            segment_samples=1024)


def test_decode_dp_cli(tmp_path):
    """tests/test_recipe.py:70: after a few bin.train steps, `decode --dp`
    over two host devices (mesh.num_devices=2) writes the same wav bytes
    as the plain decode with the same --seed; 3 utterances, padded to 4
    rows and trimmed."""
    cfg = tiny_train_cfg(checkpoint_every=4, log_every=2)
    cfg.data = dataclasses.replace(cfg.data, segment_length=400)
    (tmp_path / "config.json").write_text(cfg.to_json())
    feats = _corpus(tmp_path, cfg)
    common = ["--config", str(tmp_path / "config.json"),
              "--feats-dir", str(feats), "--stats", str(tmp_path / "stats.h5"),
              "--device", "cpu"]
    train.main(common + ["--train-scp", str(tmp_path / "corpus/train.scp"),
                         "--workdir", str(tmp_path / "exp"), "--steps", "4"])
    wavs = {}
    for name, extra in (("single", []),
                        ("dp", ["--dp", "mesh.num_devices=2"])):
        out = tmp_path / name
        decode.main(common + ["--eval-scp",
                              str(tmp_path / "corpus/train.scp"),
                              "--workdir", str(tmp_path / "exp"),
                              "--outdir", str(out), "--seed", "3", *extra])
        wavs[name] = {p.name: p.read_bytes() for p in out.glob("*.wav")}
        summary = json.loads((out / "decode_summary.json").read_text())
    assert len(wavs["single"]) == 3 and wavs["dp"] == wavs["single"]
    assert summary["dp_devices"] == ["cpu", "cpu"]
    assert summary["model_step"] == 4
