"""A live stream's playback delay: the 95th percentile over every block
due in the window of the time from when it was due to the return of the
`StreamPool.step()` that emitted it."""
import numpy as np

KIND, UNIT, SOURCE = "end_to_end", "ms", "host_clock"


def read(rec, ctx):
    if rec.kind != "live":
        return None
    return 1e3 * float(np.percentile(rec.facts["block_latency_s"], 95))
