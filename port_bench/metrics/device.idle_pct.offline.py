"""The share of the traced window in which no operation ran on the device
(offline cells)."""
KIND, UNIT, SOURCE = "per_layer", "%", "device_trace"
LAYER = "device"
MOVES = "decode_audio_s_per_s"


def read(rec, ctx):
    if rec.kind != "offline" or rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
