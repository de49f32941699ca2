"""Host time of a `StreamPool.step()` that launched: its wall time less
the device time of its AR kernel calls, the mean over the traced steps."""
KIND, UNIT, SOURCE = "per_layer", "ms", "device_trace"
LAYER = "stream pool"
MOVES = "block_latency_p95_ms"


def read(rec, ctx):
    if rec.kind != "live" or rec.trace is None:
        return None
    steps = [s for s in rec.trace.spans.get("pb.pool.step") or []
             if s["generate_s"] > 0]
    if not steps:
        return None
    return 1e3 * sum(s["wall_s"] - s["generate_s"] for s in steps) / len(steps)
