"""Whole runs of throwaway cells from a temporary directory on the CPU
(the harness's look for a card skipped), the controls at a size a test
run holds, and the faults each cell can have, planted under the timed
path: each must come out not correct. The card tests run a cell on the
chip."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from port_bench import harness
from shallow_wavenet_tpu_torch.data.dataset import SegmentSampler
from shallow_wavenet_tpu_torch.training.trainer import Trainer

ORIG_MULTI_STEP, ORIG_DRAW = Trainer.multi_step, SegmentSampler._draw_one

E2E = {"offline": "decode_audio_s_per_s", "live": "block_latency_p95_ms",
       "train": "train_samples_per_s"}


def run(root, kind, seed=7, trace=False, readings=False, seconds=0.4):
    return harness.run_cell(f"tiny_{kind}", seed, seconds, trace, root=root,
                            device="cpu", readings=readings)


@pytest.mark.parametrize("kind", ["offline", "live", "train",
                                  "softmax_offline", "softmax_live"])
def test_a_cell_added_as_files_runs(tiny_root, kind):
    path = kind.split("_")[-1]
    out = run(tiny_root, kind, seed=2 ** 31 + 3)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", E2E[path]}
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(harness.load_json(
        tiny_root, "workloads", f"tiny_{kind}")["limits"])
    traced = run(tiny_root, kind, trace=True)
    assert traced["correct"]
    assert f"mfu_pct.{path}" in traced["metrics"]
    assert "window_s" in traced["device"]


def test_a_listed_metric_that_reads_nothing_fails_the_run(tiny_root):
    import json
    (tiny_root.parent / "BENCHMARK.json").write_text(json.dumps({
        "end_to_end": [{"name": "train_samples_per_s",
                        "workloads": ["tiny_offline"]}]}))
    with pytest.raises(RuntimeError, match="train_samples_per_s"):
        run(tiny_root, "offline")


@pytest.mark.parametrize("kind", ["offline", "live", "train"])
def test_the_control_is_not_correct(tiny_root, kind):
    out = run(tiny_root, kind, readings=True)
    limits = harness.load_json(tiny_root, "workloads", f"tiny_{kind}")[
        "limits"]
    read = out["readings"]
    assert any(read.get(f"control.{k}", 0) > lim
               for k, lim in limits.items())
    if kind == "train":
        assert any(read.get(f"half_batch.{k}", 0) > lim
                   for k, lim in limits.items())


@pytest.mark.parametrize("kind", ["offline", "live", "softmax_offline",
                                  "softmax_live"])
def test_both_heads_read_both_controls(tiny_root, kind):
    """The decode generators read the TF32 and the fp8-upsampler controls
    under the head's own number, whichever the head."""
    out = run(tiny_root, kind, readings=True)
    (check,) = out["checks"]
    read = out["readings"]
    assert set(read) == {f"control.{check}", f"control_fp8.{check}"}
    assert all(v >= 0.0 for v in read.values())
    if check == "max_sample_gap":
        # the fp8 upsampler moves every Laplace sample a little
        assert read[f"control_fp8.{check}"] > 0.0


@pytest.mark.parametrize("kind", ["offline", "live", "softmax_offline",
                                  "softmax_live"])
def test_an_altered_sample_is_not_correct(tiny_root, kind, monkeypatch):
    from shallow_wavenet_tpu_torch.ops import ar_kernel
    orig = ar_kernel.generate

    def altered(*a, **kw):
        out = orig(*a, **kw)
        # within the row's own length, which the decode trims it to
        n = out.shape[1] if kw.get("lengths") is None else kw["lengths"][0]
        out[0, n // 2] += 0.05
        return out

    monkeypatch.setattr(ar_kernel, "generate", altered)
    out = run(tiny_root, kind)
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("kind", ["softmax_offline", "softmax_live"])
def test_a_moved_class_is_not_correct(tiny_root, kind, monkeypatch):
    """Every fifth sample of the first row one class up (down at the top
    class), a valid class's value: the CDF gap catches it."""
    from port_bench import reference
    from shallow_wavenet_tpu_torch.ops import ar_kernel
    orig = ar_kernel.generate
    table = reference.mulaw_table(256).float()

    def moved(*a, **kw):
        out = orig(*a, **kw)
        ids, _ = reference.class_ids(out[0, ::5], 256)
        ids = torch.where(ids < 255, ids + 1, ids - 1)
        out[0, ::5] = table.to(out.device)[ids]
        return out

    monkeypatch.setattr(ar_kernel, "generate", moved)
    out = run(tiny_root, kind)
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["max_cdf_gap"]["value"] > 1e-3


def test_a_step_that_keeps_its_state_is_not_correct(tiny_root, monkeypatch):
    from shallow_wavenet_tpu_torch.training import trainer as tr

    def unchanged(self, state, grad):
        return dataclasses.replace(state, step=state.step + 1), \
            torch.linalg.vector_norm(grad)

    monkeypatch.setattr(tr.Trainer, "_apply", unchanged)
    out = run(tiny_root, "train")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_is_not_correct(tiny_root, monkeypatch):
    from shallow_wavenet_tpu_torch.training import trainer as tr
    orig = tr.Trainer._loss_fn

    def half(self, params, batch, generator=None):
        rows = batch["x"].shape[0] // 2
        return orig(self, params, {k: v[:rows] for k, v in batch.items()},
                    generator)

    monkeypatch.setattr(tr.Trainer, "_loss_fn", half)
    out = run(tiny_root, "train")
    assert not out["correct"]


def _reused_microbatch(self, state, group):
    # every update of the group on its first batch
    return ORIG_MULTI_STEP(self, state, {k: v[:1].expand_as(v)
                                         for k, v in group.items()})


def _state_not_carried(self, state, group):
    # each update of the group from the group's starting state
    ms = []
    for i in range(group["x"].shape[0]):
        new, m = self.step(state, {k: v[i] for k, v in group.items()})
        ms.append(m)
    return new, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


def _frames_late(self):
    x, c, spk = ORIG_DRAW(self)
    return x, np.roll(c, 1, axis=0), spk


@pytest.mark.parametrize("where, what, fault", [
    (Trainer, "multi_step", _reused_microbatch),
    (Trainer, "multi_step", _state_not_carried),
    (SegmentSampler, "_draw_one", _frames_late)],
    ids=["reused_microbatch", "state_not_carried", "frames_late"])
def test_a_broken_group_or_feed_is_not_correct(tiny_root, monkeypatch,
                                               where, what, fault):
    monkeypatch.setattr(where, what, fault)
    out = run(tiny_root, "train")
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", ["c2_offline_b8", "c2_train_b8"])
def test_a_cell_is_correct_on_the_card(card, cell):
    out = harness.run_cell(cell, 2 ** 31 + 17, 2.0, False, readings=True)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    limits = harness.load_cell(cell).spec["limits"]
    assert any(out["readings"].get(f"control.{k}", 0) > lim
               for k, lim in limits.items())
