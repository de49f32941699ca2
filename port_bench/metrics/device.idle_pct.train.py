"""The share of the untraced window in which no operation ran on the
device (train cells): the traced stretch's device busy time per update,
times the updates of the untraced window, over its length
(`metrics_common.untraced_idle_pct`)."""
from port_bench.metrics_common import untraced_idle_pct

KIND, UNIT, SOURCE = "per_layer", "%", "device_trace"
LAYER = "device"
MOVES = "train_samples_per_s"


def read(rec, ctx):
    return untraced_idle_pct(rec, "train")
