"""The program's own spans, as the per-layer metrics of the decode entry
and the stream pool read them.

The program (`shallow_wavenet_tpu_torch.utils.observability`) records a
span only while the profiler is on, so in a traced run its buffer holds
the traced stretch: the benchmark's own `pb.*` range around each traced
call or step, and inside it the program's tree of `swt.*` spans. A reader
takes the last n roots of one name, n the count of the benchmark's ranges
around them, so that spans left by an earlier run in the same process are
not read. Each record: `index`, `name`, `id`, `parent` (an index or None),
`start_ns`, `end_ns`.

A program that records no spans (older than `observability.span`) has no
such metric: `kind()` then names a kind the harness does not read, so the
metric is left out of the result's line instead of failing the run.
"""

from __future__ import annotations


def kind() -> str:
    """"per_layer" where the program records spans, else "absent"."""
    from shallow_wavenet_tpu_torch.utils import observability
    return ("per_layer" if hasattr(observability, "recorded_spans")
            else "absent")


def records() -> list[dict]:
    from shallow_wavenet_tpu_torch.utils import observability
    return observability.recorded_spans()


def ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def trees(spans, root: str, n: int) -> list[tuple[dict, list[dict]]]:
    """(root, every span below it) for the last n spans named `root` that
    have no parent, in the order they ended."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    roots = [s for s in spans if s["name"] == root and s["parent"] is None]
    out = []
    for r in roots[-n:] if n > 0 else []:
        below, todo = [], [r["index"]]
        while todo:
            for s in kids.get(todo.pop(), []):
                below.append(s)
                todo.append(s["index"])
        out.append((r, below))
    return out


def named(below, *names) -> list[dict]:
    return [s for s in below if s["name"] in names]


def traced_count(rec, pb_span: str) -> int:
    """The benchmark's ranges named `pb_span` in the traced run."""
    return len(rec.trace.spans.get(pb_span) or [])
