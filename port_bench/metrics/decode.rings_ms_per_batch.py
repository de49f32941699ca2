"""The global ring's allocation and zeroing per `decode_batch` call, from
the program's own `swt.ar.rings` spans (the cluster kernel's wide form),
the mean over the traced calls; nothing where no traced call made one."""
from port_bench import program_spans as ps

KIND, UNIT, SOURCE = ps.kind(), "ms", "program_span"
LAYER = "decode entry"
MOVES = "decode_audio_s_per_s"


def value(spans, n):
    calls = [ps.named(b, "swt.ar.rings")
             for _, b in ps.trees(spans, "swt.decode.batch", n)]
    if not any(calls):
        return None
    return sum(sum(map(ps.ms, rings)) for rings in calls) / len(calls)


def read(rec, ctx):
    if rec.kind != "offline" or rec.trace is None:
        return None
    return value(ps.records(), ps.traced_count(rec, "pb.decode_batch"))
