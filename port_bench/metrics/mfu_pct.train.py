"""The training update's share of the card's dense bf16 peak (the
configuration computes in bf16): chip_smoke's `train_flops` at the
update's B and x length, times the window's updates, over its wall time
times 989 TFLOP/s."""
from port_bench import yardstick

KIND, UNIT, SOURCE = "per_layer", "%", "host_clock"
LAYER = "whole step"
MOVES = "train_samples_per_s"


def read(rec, ctx):
    if rec.kind != "train":
        return None
    f = rec.facts
    flops = yardstick.train_flops(f["model"], f["B"], f["x_len"])
    flops *= f["updates"]
    return 100.0 * flops / rec.window_s / yardstick.PEAK_BF16_FLOPS
