"""Training throughput: waveform samples the loss is taken over (B x
segment per update), summed over the window's updates, over its wall
time."""
KIND, UNIT, SOURCE = "end_to_end", "samples/s", "host_clock"


def read(rec, ctx):
    if rec.kind != "train":
        return None
    f = rec.facts
    return f["updates"] * f["B"] * f["segment"] / rec.window_s
