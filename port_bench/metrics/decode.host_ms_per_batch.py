"""Host time of a `decode_batch` call: its wall time less the device time
of the AR kernel call inside it (upsampling, noise, weight packing, launch
and copy-back, with the card idle), the mean over the traced calls."""
KIND, UNIT, SOURCE = "per_layer", "ms", "device_trace"
LAYER = "decode entry"
MOVES = "decode_audio_s_per_s"


def read(rec, ctx):
    if rec.kind != "offline" or rec.trace is None:
        return None
    calls = rec.trace.spans.get("pb.decode_batch") or []
    if not calls:
        return None
    return 1e3 * sum(c["wall_s"] - c["generate_s"] for c in calls) / len(calls)
