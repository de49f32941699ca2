"""The AR kernel's share of its roofline in the offline decode: the least
time of each traced `ar_kernel.generate` call (the unfused model's
operations at the call's B and T over 67 TFLOP/s fp32, or its bytes over
3.35 TB/s) over the device time of what the call launched."""
from port_bench.metrics_common import roofline_pct

KIND, UNIT, SOURCE = "per_layer", "%", "device_trace"
LAYER = "AR kernel"
MOVES = "decode_audio_s_per_s"


def read(rec, ctx):
    return roofline_pct(rec, "offline")
