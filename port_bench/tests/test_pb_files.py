"""The benchmark's files: each loads by name, BENCHMARK.json agrees with
them, the arithmetic copies chip_smoke's numbers, and the import check."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from port_bench import harness, yardstick

REPO = harness.ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def names(kind: str) -> list[str]:
    return sorted(p.stem for p in (harness.ROOT / kind).glob("*.json"))


@pytest.mark.parametrize("cell", names("workloads"))
def test_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.spec["chips"] in (1, 4)
    assert c.mix["generator"] in {p.stem for p in
                               (harness.ROOT / "generators").glob("*.py")}
    # a limit of 0 is an exact comparison (a count)
    assert c.spec["limits"] and all(v >= 0 for v in c.spec["limits"].values())


@pytest.mark.parametrize("config", names("configs"))
def test_config_is_the_ports_preset(config):
    from shallow_wavenet_tpu_torch.config import get_config
    c = harness.load_json(harness.ROOT, "configs", config)
    assert c["config"] == json.loads(json.dumps(
        get_config(c["name"]).to_dict()))
    assert set(c["reduced"]) <= set(c)


def test_benchmark_json_names_the_files():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for name, w in cells.items():
        spec = harness.load_json(harness.ROOT, "workloads", name)
        assert (spec["config"], spec["traffic"], spec["chips"], spec["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
    for c in BENCH["configs"]:
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        assert json.loads((REPO / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    readers = harness.readers(harness.ROOT)
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            r = readers[m["name"]]
            assert (r.KIND, r.UNIT, r.SOURCE) == (kind, m["unit"], m["source"])
            if kind == "per_layer":
                assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"])
                assert set(m["workloads"]) <= set(cells)
    listed = {m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]}
    assert listed <= set(readers)


def test_roofline_count_is_chip_smokes():
    """config 2, B = 8, T = 48,000: chip_smoke's unfused bound, 5.261 ms,
    by operations; train_flops at B = 8, x (8, 8,320) over the fp32 peak:
    2.828 ms."""
    c2 = harness.load_json(harness.ROOT, "configs",
                           "shallow_laplace_single")["config"]["model"]
    ms, by = yardstick.ar_bound_ms(c2, 8, 48000)
    assert round(ms, 3) == 5.261 and by == "operations"
    fl = yardstick.train_flops(c2, 8, 8320)
    assert round(1e3 * fl / yardstick.PEAK_FP32_FLOPS, 3) == 2.828


def test_import_check_compares_whole_top_level_names():
    bad = harness.forbidden_modules(
        ["jax", "shallow_wavenet_tpu", "shallow_wavenet_tpu.x", "flax.core",
         "shallow_wavenet_tpu_torch", "shallow_wavenet_tpu_torch.x",
         "jaxtyping", "numpy"])
    assert bad == ["flax.core", "jax", "shallow_wavenet_tpu",
                   "shallow_wavenet_tpu.x"]


@pytest.mark.parametrize("module", ["reference.py", "yardstick.py",
                                    "inputs.py"])
def test_yardstick_imports_nothing_of_the_program(module):
    tree = ast.parse((harness.ROOT / module).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert {m.split(".")[0] for m in mods} <= {"torch", "numpy", "math",
                                               "statistics", "port_bench",
                                               "__future__"}
    assert all(m in ("port_bench.yardstick",) for m in mods
               if m.startswith("port_bench"))


def test_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and port_bench, a run
    exits non-zero and prints no result."""
    import shutil
    shutil.copytree(harness.ROOT, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "c2_offline_b8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
