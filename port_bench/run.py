"""Run one cell of the port's benchmark once and print its result.

    python3 port_bench/run.py --workload c2_offline_b8 --seed 7 \
        --seconds 30 --trace 0

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its
per-layer metrics (a profiled stretch of the same run). The last line of
standard output is one JSON object; the numbers the correctness check
compared, each beside its limit, are the last lines of standard error.
Run it from the root of a checkout: the program (`shallow_wavenet_tpu_torch`)
is imported from there and builds its kernels into its own `build/`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    harness.report(out, harness.card_power_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
