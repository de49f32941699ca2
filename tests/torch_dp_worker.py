"""One rank of tests/test_torch_parallel.py's 2-rank gloo group on the CPU.

`run(rank, world, port, out)` is started once per rank by
torch.multiprocessing (spawn). It joins the group the way `torchrun` makes
a rank join it: the launcher's variables in the environment, then
`parallel.init_distributed(..., "cpu")`. Then it runs the checks, each on
this rank's rows, and writes what the test compares to
`<out>/rank<r>.npz` (arrays) and `<out>/rank<r>.json` (the rest):

- three data-parallel updates from the flax tree in `<out>/tree.npz`
  (`step_*`);
- one update with grad_accum = 2 and one without, on one batch
  (`accum_*`, `plain_*`);
- DROP_STEPS updates with context dropout (`drop_*`), and this rank's
  mask on a waveform of ones (`drop_mask`);
- `Trainer.fit` over 30 updates (`fit30_params`; rank 0 alone writes
  `<out>/fit30/`);
- `fit` at steps_per_call = 4 straight to 12 updates (`<out>/straight`),
  and to 8 then resumed from its checkpoint to 12 (`<out>/resumed`):
  `straight_params`, `resumed_params`, this rank's restored sampler state;
- `bin.train` on the corpus in `<out>/corpus` under the same launch
  (`<out>/cli`);
- the refusal of `mesh.num_devices` smaller than the world.

The shared helpers live here so that the test makes the single-process
reference from the same utterances: each rank's sampler draws from its
shard of them with a seed of its own (`100 + rank`, as
tests/multiproc_worker.py does), so the ranks' sampler states differ, and
the reference's global batch is the row concatenation of the ranks'
batches (`ConcatSampler`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from shallow_wavenet_tpu_torch.bin import train
from shallow_wavenet_tpu_torch.config import MeshConfig
from shallow_wavenet_tpu_torch.data.dataset import (
    SegmentSampler, Utterance, shard_list,
)
from shallow_wavenet_tpu_torch.data.synthetic import synth_utterance
from shallow_wavenet_tpu_torch.models.wavenet import load_params_npz
from shallow_wavenet_tpu_torch.parallel import init_distributed, shutdown
from shallow_wavenet_tpu_torch.training import Trainer

from tests.test_torch_train_loop import log_mel, tiny_train_cfg

N_RANKS = 2
N_UTTS = 4
STEP_B, ACCUM_B, FIT_B = 4, 8, 4      # rows per rank
DP_STEPS, FIT_STEPS = 3, 30
DROP_STEPS = 2
DROPOUT = dict(context_dropout=0.5, context_dropout_span_ms=10.0)
K, RESUME_AT, RESUME_TO = 4, 8, 12
CLI_STEPS = 6


def step_cfg(batch: int = STEP_B, **train):
    cfg = tiny_train_cfg(**train)
    cfg.data = dataclasses.replace(cfg.data, batch_size=batch)
    return cfg


def resume_cfg(batch: int = FIT_B):
    return step_cfg(batch, steps_per_call=K, checkpoint_every=K,
                    log_every=1)


def utterances(cfg) -> list[Utterance]:
    out = []
    for i in range(N_UTTS):
        wav = synth_utterance(i, cfg.data.sample_rate, 0.5)
        out.append(Utterance(wav=wav, feats=log_mel(cfg, wav)))
    return out


def rank_sampler(cfg, utts, rank: int) -> SegmentSampler:
    """Rank `rank`'s sampler: its shard, `data.batch_size` rows, seed
    100 + rank."""
    return SegmentSampler(
        shard_list(utts, rank, N_RANKS), batch_size=cfg.data.batch_size,
        segment_length=cfg.data.segment_length,
        hop_length=cfg.data.hop_length,
        receptive_field=cfg.model.receptive_field, seed=100 + rank)


class ConcatSampler:
    """The single-process reference's sampler: the global batch is the
    row concatenation of every rank's batch."""

    def __init__(self, cfg, utts):
        self.samplers = [rank_sampler(cfg, utts, r) for r in range(N_RANKS)]

    def __iter__(self):
        return self

    def __next__(self):
        parts = [next(s) for s in self.samplers]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def run(rank: int, world: int, port: int, out: str) -> None:
    out = Path(out)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dev = init_distributed(MeshConfig(), "cpu")
    try:
        arrays, facts = _checks(rank, dev, out)
    finally:
        shutdown()
    np.savez(out / f"rank{rank}.npz", **arrays)
    (out / f"rank{rank}.json").write_text(json.dumps(facts))


def _checks(rank: int, dev, out: Path) -> tuple[dict, dict]:
    arrays, facts = {}, {}
    tree = load_params_npz(out / "tree.npz")
    cfg = step_cfg()
    utts = utterances(cfg)

    tr = Trainer(cfg, dev)
    facts["dp"] = tr.dp
    state, sampler = tr.init_state(tree=tree), rank_sampler(cfg, utts, rank)
    ms = []
    for _ in range(DP_STEPS):
        state, m = tr.step(state, next(sampler))
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    arrays["step_metrics"] = np.array(ms)
    arrays["step_params"] = state.params.numpy()

    acfg = step_cfg(ACCUM_B)
    batch = next(rank_sampler(acfg, utts, rank))
    for name, c in (("plain", acfg),
                    ("accum", step_cfg(ACCUM_B, grad_accum=2))):
        t = Trainer(c, dev)
        s, m = t.step(t.init_state(tree=tree), batch)
        arrays[f"{name}_loss"] = np.float32(m["loss"])
        arrays[f"{name}_params"] = s.params.numpy()

    dcfg = step_cfg(**DROPOUT)
    t, dsampler = Trainer(dcfg, dev), rank_sampler(dcfg, utts, rank)
    s, ms = t.init_state(tree=tree), []
    for _ in range(DROP_STEPS):
        s, m = t.step(s, next(dsampler))
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    arrays["drop_metrics"] = np.array(ms)
    arrays["drop_params"] = s.params.numpy()
    ones = torch.ones(STEP_B, dcfg.data.segment_length)
    arrays["drop_mask"] = t._context_dropout(
        ones, t._dropout_generator(0, 0)).numpy()

    fcfg = step_cfg(FIT_B)
    t = Trainer(fcfg, dev)
    s = t.fit(t.init_state(), rank_sampler(fcfg, utts, rank), out / "fit30",
              steps=FIT_STEPS)
    arrays["fit30_params"] = s.params.numpy()

    rcfg = resume_cfg()
    t = Trainer(rcfg, dev)
    s = t.fit(t.init_state(tree=tree), rank_sampler(rcfg, utts, rank),
              out / "straight", steps=RESUME_TO)
    arrays["straight_params"] = s.params.numpy()
    t.fit(t.init_state(tree=tree), rank_sampler(rcfg, utts, rank),
          out / "resumed", steps=RESUME_AT)
    # fit's last checkpoint ends at a barrier: rank 0's files are whole
    s, sampler_state, step = t.restore(out / "resumed", t.init_state())
    facts["restored_step"] = step
    facts["restored_sampler"] = sampler_state
    sampler = rank_sampler(rcfg, utts, rank)
    sampler.set_state(sampler_state)
    s = t.fit(s, sampler, out / "resumed", steps=RESUME_TO)
    arrays["resumed_params"] = s.params.numpy()

    corpus = out / "corpus"
    train.main(["--config", str(corpus / "config.json"),
                "--feats-dir", str(corpus / "feats"),
                "--stats", str(corpus / "stats.h5"),
                "--train-scp", str(corpus / "corpus/train.scp"),
                "--dev-scp", str(corpus / "corpus/eval.scp"),
                "--workdir", str(out / "cli"), "--steps", str(CLI_STEPS),
                "--device", "cpu"])

    try:
        init_distributed(MeshConfig(num_devices=1), "cpu")
        facts["num_devices_refused"] = None
    except ValueError as e:
        facts["num_devices_refused"] = str(e)
    return arrays, facts
