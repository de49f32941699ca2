"""Host time per group of K updates spent waiting on the prefetcher's
next group, over the window."""
KIND, UNIT, SOURCE = "per_layer", "ms", "host_clock"
LAYER = "data path"
MOVES = "train_samples_per_s"


def read(rec, ctx):
    if rec.kind != "train" or not rec.facts["groups"]:
        return None
    return 1e3 * rec.facts["data_wait_s"] / rec.facts["groups"]
