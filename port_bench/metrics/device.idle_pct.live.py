"""The share of the untraced window in which no operation ran on the
device (live cells): the traced stretch's device busy time per AR kernel launch,
times the AR kernel launchs of the untraced window, over its length
(`metrics_common.untraced_idle_pct`)."""
from port_bench.metrics_common import untraced_idle_pct

KIND, UNIT, SOURCE = "per_layer", "%", "device_trace"
LAYER = "device"
MOVES = "block_latency_p95_ms"


def read(rec, ctx):
    return untraced_idle_pct(rec, "live")
