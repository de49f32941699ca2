"""AR kernel launches per `StreamPool.step()` that emitted, from the
pool's `dispatches` counter over the window."""
KIND, UNIT, SOURCE = "per_layer", "launches", "program_counter"
LAYER = "stream pool"
MOVES = "block_latency_p95_ms"


def read(rec, ctx):
    if rec.kind != "live" or not rec.facts["steps"]:
        return None
    return rec.facts["launches"] / len(rec.facts["steps"])
