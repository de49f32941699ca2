"""Upsampler calls per `StreamPool.step()` that launched, from the
program's own spans: the count of its `swt.stream.upsample` spans, the
mean over the traced steps that hold a `swt.pool.launch`."""
from port_bench import program_spans as ps

KIND, UNIT, SOURCE = ps.kind(), "calls", "program_span"
LAYER = "stream pool"
MOVES = "block_latency_p95_ms"


def value(spans, n):
    steps = [b for _, b in ps.trees(spans, "swt.pool.step", n)
             if ps.named(b, "swt.pool.launch")]
    if not steps:
        return None
    return sum(len(ps.named(b, "swt.stream.upsample"))
               for b in steps) / len(steps)


def read(rec, ctx):
    if rec.kind != "live" or rec.trace is None:
        return None
    return value(ps.records(), ps.traced_count(rec, "pb.pool.step"))
