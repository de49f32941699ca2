"""Weight preparation per `decode_batch` call from the program's own
spans: `swt.decode.params` (the plain params from the model) plus
`swt.ar.pack` (the kernel's weights from them), the mean over the traced
calls."""
from port_bench import program_spans as ps

KIND, UNIT, SOURCE = ps.kind(), "ms", "program_span"
LAYER = "decode entry"
MOVES = "decode_audio_s_per_s"


def value(spans, n):
    calls = ps.trees(spans, "swt.decode.batch", n)
    if not calls:
        return None
    return sum(sum(map(ps.ms, ps.named(b, "swt.decode.params",
                                       "swt.ar.pack")))
               for _, b in calls) / len(calls)


def read(rec, ctx):
    if rec.kind != "offline" or rec.trace is None:
        return None
    return value(ps.records(), ps.traced_count(rec, "pb.decode_batch"))
