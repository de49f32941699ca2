"""The stream pool's share of the card's fp32 peak: model FLOPs of the
samples the window's steps emitted and their frames over the window times
67 TFLOP/s. The warm-up steps each block's launch repeats are not counted:
they are waste."""
from port_bench import yardstick

KIND, UNIT, SOURCE = "per_layer", "%", "host_clock"
LAYER = "whole step"
MOVES = "block_latency_p95_ms"


def read(rec, ctx):
    if rec.kind != "live":
        return None
    f = rec.facts
    flops = yardstick.decode_flops(f["model"], f["samples"], f["frames"])
    return 100.0 * flops / rec.window_s / yardstick.PEAK_FP32_FLOPS
