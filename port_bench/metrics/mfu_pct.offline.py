"""The whole decode's share of the card's fp32 peak: model FLOPs of the
delivered (trimmed) samples and their frames over the window's wall time
times 67 TFLOP/s. Padding is not counted: it is waste."""
from port_bench import yardstick

KIND, UNIT, SOURCE = "per_layer", "%", "host_clock"
LAYER = "whole step"
MOVES = "decode_audio_s_per_s"


def read(rec, ctx):
    if rec.kind != "offline":
        return None
    f = rec.facts
    flops = yardstick.decode_flops(f["model"], f["samples"], f["frames"])
    return 100.0 * flops / rec.window_s / yardstick.PEAK_FP32_FLOPS
