"""Host time of a `StreamPool.step()` that launched, from the program's
own spans: its `swt.pool.step` span less its `swt.pool.copy_back` (the
host's wait on the kernel and the copy), the mean over the traced steps
that hold a `swt.pool.launch`."""
from port_bench import program_spans as ps

KIND, UNIT, SOURCE = ps.kind(), "ms", "program_span"
LAYER = "stream pool"
MOVES = "block_latency_p95_ms"


def value(spans, n):
    steps = [(r, b) for r, b in ps.trees(spans, "swt.pool.step", n)
             if ps.named(b, "swt.pool.launch")]
    if not steps:
        return None
    return sum(ps.ms(r) - sum(map(ps.ms, ps.named(b, "swt.pool.copy_back")))
               for r, b in steps) / len(steps)


def read(rec, ctx):
    if rec.kind != "live" or rec.trace is None:
        return None
    return value(ps.records(), ps.traced_count(rec, "pb.pool.step"))
