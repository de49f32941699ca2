"""The benchmark's files: each loads by name, BENCHMARK.json agrees with
them, the arithmetic copies chip_smoke's numbers, and the import check."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from port_bench import harness, reference, yardstick

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
    if c.mix["generator"] in ("offline", "live"):
        # the number the decode's check compares is its head's
        assert set(c.spec["limits"]) == {
            reference.judge(c.config["config"]["model"])[0]}


DESCRIBED = ("source", "stated", "reduced", "assumed", "precision",
             "weights", "corpus")


def plain(x):
    return json.loads(json.dumps(x))


def config_faults(c: dict, stem: str) -> list[str]:
    """What is wrong with configuration file `configs/<stem>.json`, whose
    content is `c`. A file named after one of the port's presets holds
    that preset's tree exactly. Any other file holds a tree of its own
    name, not a preset's, that the port's Config reads back unchanged,
    whose conditioning width is its features' and which the AR kernel
    takes. Either kind describes itself: DESCRIBED's keys, with `reduced`
    naming keys of the file."""
    from shallow_wavenet_tpu_torch.config import (
        PRESETS, Config, feature_dim, get_config)
    from shallow_wavenet_tpu_torch.ops import ar_kernel
    faults = [f"no {k!r}" for k in DESCRIBED if k not in c]
    if not set(c.get("reduced", ())) <= set(c):
        faults.append("`reduced` names keys the file lacks")
    tree = c.get("config", {})
    if c.get("name") != stem or tree.get("name") != stem:
        faults.append(f"name {c.get('name')!r}, tree {tree.get('name')!r}, "
                      f"file {stem!r} differ")
    if stem in PRESETS:
        if tree != plain(get_config(stem).to_dict()):
            faults.append(f"differs from the port's preset {stem!r}")
        return faults
    if c.get("name") in PRESETS or tree.get("name") in PRESETS:
        faults.append("takes a preset's name")
    try:
        cfg = Config.from_dict(tree)
        if plain(cfg.to_dict()) != tree:
            faults.append("the port's Config does not read it back as it is")
        if cfg.model.aux_channels != feature_dim(cfg):
            faults.append(f"aux_channels {cfg.model.aux_channels} is not the "
                          f"features' {feature_dim(cfg)}")
        ar_kernel.check_supported(cfg.model)
    except (KeyError, TypeError, ValueError) as e:
        faults.append(f"{type(e).__name__}: {e}")
    return faults


@pytest.mark.parametrize("config", names("configs"))
def test_config_is_the_ports_preset(config):
    """A preset-named file is the preset exactly; any other file passes
    `config_faults`' rules for configurations of their own."""
    c = harness.load_json(harness.ROOT, "configs", config)
    assert config_faults(c, config) == []


def _write(tmp_path, stem, c):
    (tmp_path / f"{stem}.json").write_text(json.dumps(c))
    return json.loads((tmp_path / f"{stem}.json").read_text())


def _own(tmp_path, stem="c2_wide", **model):
    """Config 2's file as a configuration of its own named `stem`, with
    `model` changed."""
    c = harness.load_json(harness.ROOT, "configs", "shallow_laplace_single")
    c["name"] = c["config"]["name"] = stem
    c["config"]["model"].update(model)
    return _write(tmp_path, stem, c)


def test_a_configuration_of_its_own_is_accepted(tmp_path):
    c = _own(tmp_path, residual_channels=512, gate_channels=1024,
             skip_channels=256, head="softmax", n_stacks=3, stack_size=10)
    assert config_faults(c, "c2_wide") == []


@pytest.mark.parametrize("change, fault", [
    ({"residual_channels": 65}, "differs from the port's preset"),
    ({"head": "softmax"}, "differs from the port's preset")])
def test_a_preset_named_file_that_differs_is_refused(tmp_path, change,
                                                      fault):
    c = harness.load_json(harness.ROOT, "configs", "deep_baseline")
    c["config"]["model"].update(change)
    c = _write(tmp_path, "deep_baseline", c)
    assert any(fault in f for f in config_faults(c, "deep_baseline"))


def test_a_file_that_takes_a_presets_name_is_refused(tmp_path):
    # named after a preset in the file, under a stem of its own
    c = _own(tmp_path, "c2_copy", head="softmax")
    c["name"] = c["config"]["name"] = "shallow_softmax_single"
    faults = config_faults(c, "c2_copy")
    assert any("takes a preset's name" in f for f in faults)


@pytest.mark.parametrize("drop", DESCRIBED)
def test_a_file_without_its_description_is_refused(tmp_path, drop):
    c = _own(tmp_path)
    del c[drop]
    assert f"no {drop!r}" in config_faults(c, "c2_wide")


@pytest.mark.parametrize("model, fault", [
    ({"aux_channels": 28}, "aux_channels"),
    ({"kernel_size": 3}, "kernel_size"),
    ({"gate_chanels": 8}, "unknown config key")])
def test_a_file_the_port_cannot_run_is_refused(tmp_path, model, fault):
    c = _own(tmp_path, **model)
    assert any(fault in f for f in config_faults(c, "c2_wide"))


def test_a_file_named_apart_from_its_tree_is_refused(tmp_path):
    c = _own(tmp_path)
    c["config"]["name"] = "other"
    assert any("differ" in f for f in config_faults(c, "c2_wide"))


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


def _ar_bound_before(mc, B, T, weight_bytes=4, dtype="float32"):
    # ar_bound_ms as it read before it took the rows' lengths and the
    # weights beyond the card's on-chip storage
    C = mc["cond_channels"]
    flops = 2.0 * yardstick.ar_step_macs(mc) * B * T
    nbytes = (4.0 * (B * T * C + 2 * B * T)
              + weight_bytes * yardstick.ar_weight_count(mc))
    t_ops = flops / yardstick.PEAKS[dtype]
    t_bytes = nbytes / yardstick.PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def model_of(config):
    return harness.load_json(harness.ROOT, "configs", config)["config"][
        "model"]


@pytest.mark.parametrize("config", ["shallow_laplace_single",
                                    "deep_baseline"])
@pytest.mark.parametrize("B, T, wb, dtype", [
    (8, 48000, 4, "float32"), (8, 38400, 4, "float32"),
    (7, 4096, 2, "bfloat16"), (1, 1, 4, "float32"), (3, 64, 2, "bfloat16")])
def test_ar_bound_without_lengths_is_unchanged(config, B, T, wb, dtype):
    mc = model_of(config)
    assert yardstick.ar_bound_ms(mc, B, T, wb, dtype) \
        == _ar_bound_before(mc, B, T, wb, dtype)
    assert yardstick.ar_bound_ms(mc, B, T, wb, dtype, lengths=None) \
        == _ar_bound_before(mc, B, T, wb, dtype)


@pytest.mark.parametrize("config", ["shallow_laplace_single",
                                    "deep_baseline"])
def test_ar_bound_counts_the_steps_rows_run(config):
    """The offline mix's rows (75-150 frames at hop 320): the operations
    scale by sum(lengths) / (B T) = 900 / 1200."""
    mc = model_of(config)
    lengths = [320 * f for f in (75, 86, 96, 107, 118, 129, 139, 150)]
    B, T = 8, 48000
    padded, by = yardstick.ar_bound_ms(mc, B, T)
    run, by_run = yardstick.ar_bound_ms(mc, B, T, lengths=lengths)
    assert by == by_run == "operations" and sum(lengths) == 900 * 320
    assert run / padded == pytest.approx(sum(lengths) / (B * T), rel=1e-12)
    # all rows at full length is the padded call
    assert yardstick.ar_bound_ms(mc, B, T, lengths=[T] * B) == (padded, by)


R512 = {"n_stacks": 3, "stack_size": 10, "residual_channels": 512,
        "gate_channels": 1024, "skip_channels": 256, "cond_channels": 32,
        "kernel_size": 2, "head": "softmax", "quantize_channels": 256}


def test_on_chip_bytes_and_the_weights_beyond_them():
    assert yardstick.ON_CHIP_BYTES == 121_634_816
    wb = 4 * yardstick.ar_weight_count(R512)
    assert wb - yardstick.ON_CHIP_BYTES == 56_578_048
    # the per-step term: one step reads the weights once; each step after
    # the first reads the excess again
    ms, by = yardstick.ar_bound_ms(R512, 1, 1)
    assert (ms, by) == (1e3 * (4.0 * (32 + 2) + wb) / yardstick.PEAK_BYTES,
                        "bytes")
    ms, by = yardstick.ar_bound_ms(R512, 1, 2)
    want = (4.0 * 2 * (32 + 2) + wb + 56_578_048) / yardstick.PEAK_BYTES
    assert (ms, by) == (1e3 * want, "bytes")
    # 16.9 us a step from HBM at B = 8, T = 1,000, against 10.6 of
    # operations: the bound is the bytes'
    ms, by = yardstick.ar_bound_ms(R512, 8, 1000)
    assert by == "bytes" and 16.8e-3 < ms / 1000 < 17.1e-3
    # with lengths, the term runs for the longest row's steps
    a = yardstick.ar_bound_ms(R512, 8, 1000, lengths=[1000] + [10] * 7)[0]
    b = yardstick.ar_bound_ms(R512, 8, 1000, lengths=[500] + [10] * 7)[0]
    assert 1.9 < a / b < 2.0


@pytest.mark.parametrize("config", ["shallow_laplace_single",
                                    "deep_baseline"])
def test_weights_that_fit_on_chip_add_no_per_step_term(config):
    mc = model_of(config)
    assert 4 * yardstick.ar_weight_count(mc) < yardstick.ON_CHIP_BYTES
    one = yardstick.ar_bound_ms(mc, 8, 1000, lengths=[1000] * 8)[0]
    assert one == _ar_bound_before(mc, 8, 1000)[0]


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
