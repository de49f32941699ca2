"""The benchmark's core: find a cell's files by name, run its traffic
generator once, read its metrics, judge its outputs and print the result.

Layout, all under this directory and each found by its name:
- `workloads/<cell>.json`: the cell: its configuration, traffic mix,
  chips, why, and the limits of its correctness numbers;
- `configs/<config>.json`: the configuration as it is run (`config`: the
  port's whole `Config` tree) with its source, cuts and stated precision;
- `mixes/<mix>.json`: the traffic: the `generator` that generates it and its
  parameters;
- `generators/<generator>.py`: one general generator per kind of traffic
  (`run(ctx) -> Record`);
- `metrics/<metric>.py`: one reader per metric (`KIND`, `UNIT`, `read`).
Adding a cell, configuration, mix or metric is adding a file.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# top-level module names no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "shallow_wavenet_tpu")


def forbidden_modules(names) -> list[str]:
    """The names whose top-level part (before the first dot) is, whole,
    one of FORBIDDEN."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_json(root: Path, kind: str, name: str) -> dict:
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readers(root: Path) -> dict:
    """{metric name: reader module} of every file in `metrics/`."""
    out = {}
    for path in sorted((Path(root) / "metrics").glob("*.py")):
        name = path.name[:-3]
        out[name] = load_module(path, "pb_metric_" + name.replace(".", "_"))
    return out


def required_metrics(bench: dict, cell: str, kind: str) -> set[str]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that
    BENCHMARK.json's entries `bench` have cell `cell` report: those whose
    `workloads` list it, and those with no such list (a per-layer one,
    wherever the metric it moves is reported)."""
    e2e = {m["name"] for m in bench.get("end_to_end", [])
           if cell in m.get("workloads", [cell])}
    if kind == "end_to_end":
        return e2e
    return {m["name"] for m in bench.get("per_layer", [])
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)}


@dataclass
class Cell:
    name: str
    spec: dict          # workloads/<cell>.json
    config: dict        # configs/<config>.json
    mix: dict           # mixes/<mix>.json


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_json(root, "workloads", name)
    return Cell(name, spec, load_json(root, "configs", spec["config"]),
                load_json(root, "mixes", spec["traffic"]))


@dataclass
class Record:
    """What a generator's run leaves for the metric readers and the verdict."""
    kind: str                       # the generator's name
    window_s: float                 # the measured window, host clock
    facts: dict = field(default_factory=dict)
    checks: list = field(default_factory=list)   # [(name, value, limit)]
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace: object = None            # profiling.Trace of a traced run


@dataclass
class Context:
    """What a generator gets: the run's arguments and the cell's files."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object                  # torch.device
    t_start: float                  # process start, host clock
    readings: bool = False          # also read the control and faults
    setup_s: float | None = None
    marks: list = field(default_factory=list)   # set-up's steps, host clock

    @property
    def mix(self) -> dict:
        return self.cell.mix

    @property
    def limits(self) -> dict:
        return self.cell.spec["limits"]

    def program_config(self):
        """The port's Config of this cell's configuration file."""
        from shallow_wavenet_tpu_torch.config import Config
        return Config.from_dict(self.cell.config["config"])

    def model_dict(self) -> dict:
        return dict(self.cell.config["config"]["model"])

    def log(self, msg: str) -> None:
        print(f"[port_bench] {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def mark(self, step: str, sync: bool = True) -> None:
        """Note the end of one step of set-up (printed with the window's
        opening, so that a slow set-up shows where its time went)."""
        if sync:
            self.sync()
        self.marks.append((step, time.perf_counter()))

    def window_opens(self) -> float:
        """Mark the end of set-up; returns the host clock."""
        self.mark("warm-up")
        now = self.marks[-1][1]
        self.setup_s = now - self.t_start
        steps, t = [], self.t_start
        for step, at in self.marks:
            steps.append(f"{step} {at - t:.3f}")
            t = at
        self.log(f"set-up {self.setup_s:.3f} s: " + ", ".join(steps))
        return now


def card_power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             root: Path = ROOT, device: str = "cuda",
             t_start: float | None = None, readings: bool = False) -> dict:
    """Run cell `name` once and return the result's line as a dict, with
    `checks` last. device "cuda" needs the cell's cards; "cpu" runs the
    program's plain paths (the CPU tests' rehearsal). readings: also
    read the control and the faults on the run's own inputs (under
    `readings`; `readings.py`), which the benchmark's runs never do."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root)
    chips = int(cell.spec["chips"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available: no result")
        if torch.cuda.device_count() < chips:
            raise SystemExit(f"the cell needs {chips} cards, "
                             f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    ctx = Context(cell, int(seed), float(seconds), bool(trace), dev, t_start,
                  readings)
    import shallow_wavenet_tpu_torch  # noqa: F401  (the program)
    ctx.mark("imports", sync=False)
    ctx.mark("CUDA")
    kind_of_traffic = cell.mix["generator"]
    generator = load_module(root / "generators" / f"{kind_of_traffic}.py",
                            "pb_generator_" + kind_of_traffic)
    rec: Record = generator.run(ctx)

    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    bench_file = Path(root).parent / "BENCHMARK.json"
    required = (required_metrics(json.loads(bench_file.read_text()), name,
                                 kind) if bench_file.is_file() else set())
    found = readers(root)
    missing = sorted(required - set(found))
    if missing:
        raise RuntimeError(f"no reader for the listed metrics {missing}")
    for mname, reader in found.items():
        if reader.KIND != kind:
            continue
        value = reader.read(rec, ctx)
        if value is None:
            if mname in required:
                raise RuntimeError(f"metric {mname}, which BENCHMARK.json "
                                   f"lists for {name}, read nothing")
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"metric {mname} read {value}")
        metrics[mname] = {"value": float(value), "unit": reader.UNIT}

    held = forbidden_modules(sys.modules)
    if held:
        raise SystemExit("modules of JAX or the JAX package are loaded: "
                         + ", ".join(held))
    correct = all(v <= lim for _, v, lim in rec.checks) and bool(rec.checks)
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": chips,
                   "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out = {"correct": correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": device_info}
    if trace and rec.trace is not None:
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.device_ops,
                            "idle_gaps": rec.trace.idle_gaps}
    if readings:
        out["readings"] = rec.facts["readings"]
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rec.checks}
    return out


def report(out: dict, power: str) -> None:
    """Print the result: each compared number beside its limit as the
    last lines on standard error, the result as the last line of standard
    output."""
    print(f"[port_bench] card: {power}", file=sys.stderr)
    for n, c in out["checks"].items():
        print(f"check {n} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
