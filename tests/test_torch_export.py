"""tools/export_torch_checkpoint.py: a JAX training run's Orbax checkpoint
taken to the port's layout, then resumed and decoded by the port on the
CPU.

The JAX Trainer trains a tests/test_model.py::tiny_cfg model a few steps
through `fit` (Orbax checkpoints with the SegmentSampler's state): the
Laplace head with `adam`, and the softmax head with speakers and `adamw`.
After the export:
- the port's `Trainer.restore` gives the flax parameters and Adam's two
  moments equal to the bit, the step, and the sampler state unchanged;
- one more step of each trainer from there, on the same batch, agrees
  within the fp32 trajectory tolerance of tests/test_torch_train.py (loss
  and every parameter at atol 1e-4);
- the port's `bin.decode --workdir <exported>` writes the same wavs, byte
  for byte, as `--params` on an .npz of the JAX run's parameter tree;
- `--step` exports an older checkpoint; a workdir without a checkpoint,
  and an optimizer state whose counts are not the step, are refused.
"""

import json

import jax
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.config import Config as JaxConfig
from shallow_wavenet_tpu.config import DataConfig, TrainConfig
from shallow_wavenet_tpu.data.dataset import SegmentSampler, Utterance
from shallow_wavenet_tpu.data.synthetic import synth_utterance
from shallow_wavenet_tpu.training import Trainer as JaxTrainer
from shallow_wavenet_tpu_torch.bin import decode
from shallow_wavenet_tpu_torch.config import Config
from shallow_wavenet_tpu_torch.data.hdf5_io import write_hdf5
from shallow_wavenet_tpu_torch.models.wavenet import _flatten, save_params_npz
from shallow_wavenet_tpu_torch.training import Trainer

from tests.test_model import tiny_cfg
from tests.test_train_parity_torch import _batches
from tools import export_torch_checkpoint as export

STEPS = 4
CASES = {
    "laplace_adam": dict(head="laplace", n_speakers=0, weight_decay=0.0),
    "softmax_speakers_adamw": dict(head="softmax", n_speakers=2,
                                   weight_decay=1e-2),
}


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread (tests/test_torch_recipe.py's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(head, n_speakers, weight_decay) -> JaxConfig:
    c = JaxConfig(name="export")
    c.model = tiny_cfg(head=head, n_speakers=n_speakers)
    c.data = DataConfig(sample_rate=8000, hop_length=10, n_mels=8,
                        segment_length=200, batch_size=2)
    c.train = TrainConfig(steps=STEPS, learning_rate=3e-3,
                          checkpoint_every=2, log_every=2,
                          weight_decay=weight_decay, keep_checkpoints=3)
    return c


def _sampler(cfg, seed=0):
    rng = np.random.default_rng(seed)
    utts = []
    for i in range(3):
        wav = synth_utterance(seed + i, cfg.data.sample_rate, 0.1)
        frames = len(wav) // cfg.data.hop_length
        utts.append(Utterance(
            wav=wav[: frames * cfg.data.hop_length],
            feats=rng.standard_normal(
                (frames, cfg.model.aux_channels)).astype(np.float32),
            speaker=i % max(cfg.model.n_speakers, 1)))
    return SegmentSampler(utts, batch_size=cfg.data.batch_size,
                          segment_length=cfg.data.segment_length,
                          hop_length=cfg.data.hop_length,
                          receptive_field=cfg.model.receptive_field,
                          seed=seed)


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_run(request, tmp_path_factory):
    """A JAX training run of STEPS steps (checkpoints at 2 and 4), its
    final state, and the sampler state its last checkpoint holds (the
    JAX restore's: the prefetcher's count of consumed batches, not the
    sampler's own, which has drawn ahead)."""
    cfg = _cfg(**CASES[request.param])
    wd = tmp_path_factory.mktemp(request.param) / "jax"
    trainer = JaxTrainer(cfg)
    state = trainer.fit(trainer.init_state(), _sampler(cfg), wd)
    _, sampler_state, step = trainer.restore(wd, trainer.init_state())
    assert step == STEPS and sampler_state
    return cfg, wd, trainer, state, sampler_state


def _np(tree):
    return {k: np.asarray(v)
            for k, v in _flatten(jax.device_get(tree)).items()}


def _adam(opt_state):
    import optax

    return next(x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))


def test_restore_is_the_jax_state_to_the_bit(jax_run, tmp_path):
    cfg, wd, _, state, sampler_state = jax_run
    out = tmp_path / "port"
    assert export.export(wd, out) == STEPS
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) \
        == [str(STEPS)]
    pcfg = Config.from_json((out / "config.json").read_text())
    assert pcfg.to_dict() == cfg.to_dict()
    pt = Trainer(pcfg, "cpu")
    restored, sampler, step = pt.restore(out, pt.init_state())
    assert step == restored.step == STEPS
    assert sampler == json.loads(json.dumps(sampler_state))
    adam = _adam(state.opt_state)
    for got, want in ((restored.params, state.params),
                      (restored.opt_state["mu"], adam.mu),
                      (restored.opt_state["nu"], adam.nu)):
        got, want = _flatten(pt.params_tree(got)), _np(want)
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k


def test_next_step_tracks_jax(jax_run, tmp_path):
    cfg, wd, trainer, state, _ = jax_run
    out = tmp_path / "port"
    export.export(wd, out)
    pt = Trainer(Config.from_json((out / "config.json").read_text()), "cpu")
    restored, _, _ = pt.restore(out, pt.init_state())
    batch = _batches(cfg, 1, seed=3)[0]
    # the JAX step donates its state: step a copy, the fixture's stays
    want_state, want = trainer.step_fn(
        jax.tree.map(lambda x: jax.numpy.array(x, copy=True), state), batch)
    got_state, got = pt.step(restored, batch)
    assert got_state.step == int(want_state.step) == STEPS + 1
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=0, atol=1e-4)
    got_p, want_p = _flatten(pt.params_tree(got_state.params)), _np(
        want_state.params)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_decode_of_the_export_is_the_params_decode(jax_run, tmp_path):
    cfg, wd, _, state, _ = jax_run
    out = tmp_path / "port"
    export.export(wd, out)
    rng = np.random.default_rng(4)
    feats = tmp_path / "feats"
    names = ["spk0_a.wav", "spk1_b.wav"]
    for i, n in enumerate(names):
        write_hdf5(feats / (n[:-4] + ".h5"), "feats", rng.standard_normal(
            (12 + 5 * i, cfg.model.aux_channels)).astype(np.float32))
    scp = tmp_path / "eval.scp"
    scp.write_text("".join(f"{tmp_path / n}\n" for n in names))
    npz = tmp_path / "params.npz"
    save_params_npz(npz, _np(state.params))
    common = ["--config", str(out / "config.json"), "--eval-scp", str(scp),
              "--feats-dir", str(feats), "--device", "cpu"]
    decode.main(common + ["--workdir", str(out), "--outdir",
                          str(tmp_path / "a")])
    decode.main(common + ["--params", str(npz), "--outdir",
                          str(tmp_path / "b")])
    summary = json.loads((tmp_path / "a/decode_summary.json").read_text())
    assert summary["model_step"] == STEPS
    for n in names:
        a, b = ((tmp_path / d / n).read_bytes() for d in ("a", "b"))
        assert a == b and len(a) > 44


def test_step_option_and_refusals(jax_run, tmp_path):
    cfg, wd, trainer, state, _ = jax_run
    out = tmp_path / "port"
    assert export.export(wd, out, step=2) == 2
    pt = Trainer(Config.from_json((out / "config.json").read_text()), "cpu")
    assert pt.restore(out, pt.init_state())[2] == 2
    with pytest.raises(FileNotFoundError, match="step 3"):
        export.export(wd, tmp_path / "x", step=3)
    # a workdir with its config and no checkpoint
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text(cfg.to_json())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        export.export(empty, tmp_path / "y")
    # a checkpoint whose optimizer counts are not its step
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "config.json").write_text(cfg.to_json())
    mngr = trainer._ckpt_manager(bad)
    trainer.save(mngr, state.replace(step=state.step + 1), {})
    mngr.wait_until_finished()
    with pytest.raises(ValueError, match="counts"):
        export.export(bad, tmp_path / "z")
    assert not (tmp_path / "z" / "checkpoints").exists()


def test_main_cli(jax_run, tmp_path):
    _, wd, _, _, _ = jax_run
    assert export.main([str(wd), str(tmp_path / "port")]) == STEPS
    assert (tmp_path / "port/checkpoints" / str(STEPS) / "params.npz"
            ).is_file()

