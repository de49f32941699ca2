"""Fixtures of the benchmark's own tests: a tiny model and traffic in a
temporary directory laid out as the benchmark's (configs, mixes, workloads
of their own; the generators and metric readers copied from this one), and
the card fixture."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from port_bench import harness

TINY_MODEL = {
    "n_stacks": 1, "stack_size": 3, "residual_channels": 8,
    "gate_channels": 16, "skip_channels": 16, "aux_channels": 6,
    "kernel_size": 2, "head": "laplace", "quantize_channels": 256,
    "upsample_factors": [2, 2], "cond_channels": 8, "n_speakers": 0,
    "compute_dtype": "bfloat16", "log_b_min": -9.0, "log_b_max": 3.0,
    "fold_taps": False,
}


# the softmax head at small widths: R 32, G 64, S 32, C 32, 2 x 4 layers,
# 256 mu-law classes
TINY_SOFTMAX = dict(TINY_MODEL, n_stacks=2, stack_size=4,
                    residual_channels=32, gate_channels=64, skip_channels=32,
                    cond_channels=32, head="softmax")


def tiny_config(model=None, name="tiny") -> dict:
    cfg = json.loads((harness.ROOT / "configs" /
                      "shallow_laplace_single.json").read_text())
    cfg["name"] = name
    c = cfg["config"]
    c["name"] = name
    c["model"] = dict(TINY_MODEL if model is None else model)
    c["data"].update(hop_length=4, sample_rate=200, segment_length=64,
                     batch_size=4, n_mels=6)
    c["train"].update(steps_per_call=2)
    return cfg


MIXES = {
    "tiny_offline": {"generator": "offline", "why": "test", "batch": 3,
                     "frames": [5, 8, 12], "kernel_dtype": "auto",
                     "fused": 0, "warm_frames": 2, "trace_calls": 1},
    "tiny_live": {"generator": "live", "why": "test", "streams": 2,
                  "slots": 4, "block_frames": 16, "chunk": 64,
                  "utt_seconds": [0.3, 0.4], "pause_seconds": [0.05, 0.1],
                  "warm_frames": [33, 34], "trace_at_s": 0.2,
                  "trace_s": 0.3, "drain_s": 60.0},
    "tiny_train": {"generator": "train", "why": "test", "utterances": 6,
                   "utt_seconds": 1.0, "trace_groups": 1},
}

# the tiny softmax cells: (cell, mix, limits)
SOFTMAX_CELLS = {"offline": ("tiny_softmax_offline", "tiny_offline",
                             {"max_cdf_gap": 1e-5}),
                 "live": ("tiny_softmax_live", "tiny_live",
                          {"max_cdf_gap": 1e-5})}

LIMITS = {"offline": {"max_sample_gap": 1e-5},
          "live": {"max_sample_gap": 1e-5},
          "train": {"data_rows_off": 0, "loss_gap": 1e-3, "grad_gap": 2e-2,
                    "change_gap": 2e-2}}


def make_root(path: Path) -> Path:
    """A benchmark directory at `path` holding the tiny cells."""
    for d in ("generators", "metrics"):
        shutil.copytree(harness.ROOT / d, path / d)
    for d in ("configs", "mixes", "workloads"):
        (path / d).mkdir()
    (path / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (path / "configs" / "tiny_softmax.json").write_text(json.dumps(
        tiny_config(TINY_SOFTMAX, "tiny_softmax")))
    for cell, mix, limits in SOFTMAX_CELLS.values():
        (path / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": "tiny_softmax", "traffic": mix, "chips": 1,
             "why": "test", "limits": limits}))
    for name, mix in MIXES.items():
        (path / "mixes" / f"{name}.json").write_text(json.dumps(mix))
        kind = mix["generator"]
        (path / "workloads" / f"tiny_{kind}.json").write_text(json.dumps(
            {"config": "tiny", "traffic": name, "chips": 1, "why": "test",
             "limits": LIMITS[kind]}))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path / "bench")


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the chip")
    return torch.device("cuda", 0)
