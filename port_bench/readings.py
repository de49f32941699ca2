"""The readings the correctness limits are set from: a cell's sound runs
and its control (and, for training, its faults), on many seeds in one
process.

    python3 port_bench/readings.py --workload c2_offline_b8 \
        --seeds 11,12,13 --seconds 30

Each seed runs the cell as `run.py` does, then also reads the control
(the reference in the precision below the configuration's, in the
program's place) and the faults the cell can have, on the same inputs.
Prints one JSON line per seed: the compared numbers and the readings.
The benchmark's own runs never read the control.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               readings=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "checks": out["checks"],
                          "readings": out["readings"],
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
