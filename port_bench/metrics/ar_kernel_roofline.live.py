"""The AR kernel's share of its roofline in the stream pool's launches
(each launch's own rows and steps, warm-up steps included)."""
from port_bench.metrics_common import roofline_pct

KIND, UNIT, SOURCE = "per_layer", "%", "device_trace"
LAYER = "AR kernel"
MOVES = "block_latency_p95_ms"


def read(rec, ctx):
    return roofline_pct(rec, "live")
