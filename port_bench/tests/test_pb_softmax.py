"""The softmax head's judge (`max_cdf_gap`) at config 2's widths on the
card, on a configuration file of its own (config 2 with the 256-class
mu-law softmax head, the cluster kernel's Q): the program's readings on
five seeds against the TF32 control's and the fp8 upsampler's.

    python3 -m pytest port_bench/tests/test_pb_softmax.py -q -s -m card

prints one JSON line per seed and the worst of each."""

from __future__ import annotations

import json
import shutil

import pytest

from port_bench import harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303, 2 ** 31 + 404,
         2 ** 31 + 505)
CELL = "c2_softmax_offline_b8"


def softmax_root(path):
    """A benchmark directory at `path` with config 2 as a softmax model
    under the offline_b8 mix."""
    for d in ("generators", "metrics"):
        shutil.copytree(harness.ROOT / d, path / d)
    for d in ("configs", "mixes", "workloads"):
        (path / d).mkdir()
    c = harness.load_json(harness.ROOT, "configs", "shallow_laplace_single")
    c["name"] = c["config"]["name"] = "c2_softmax"
    c["config"]["model"]["head"] = "softmax"
    (path / "configs" / "c2_softmax.json").write_text(json.dumps(c))
    shutil.copy(harness.ROOT / "mixes" / "offline_b8.json", path / "mixes")
    (path / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"config": "c2_softmax", "traffic": "offline_b8", "chips": 1,
         "why": "the softmax judge's readings", "limits": {
             "max_cdf_gap": 1e-5}}))
    return path


@pytest.mark.card
def test_the_softmax_judge_on_the_card(card, tmp_path):
    root = softmax_root(tmp_path)
    worst = {"program": 0.0, "control": 0.0, "control_fp8": 0.0}
    for seed in SEEDS:
        out = harness.run_cell(CELL, seed, 2.0, False, root=root,
                               readings=True)
        read = {"program": out["checks"]["max_cdf_gap"]["value"],
                "control": out["readings"]["control.max_cdf_gap"],
                "control_fp8": out["readings"]["control_fp8.max_cdf_gap"]}
        print(json.dumps({"seed": seed, "attempted": out["attempted"],
                          **read}), flush=True)
        worst = {k: max(v, read[k]) for k, v in worst.items()}
    print(json.dumps({"worst": worst}), flush=True)
    assert 10 * worst["program"] <= worst["control"]
