"""Device kernels per training update in the traced groups."""
KIND, UNIT, SOURCE = "per_layer", "kernels", "device_trace"
LAYER = "the update"
MOVES = "train_samples_per_s"


def read(rec, ctx):
    if rec.kind != "train" or rec.trace is None:
        return None
    return rec.trace.kernels / (rec.facts["mix"]["trace_groups"]
                                * rec.facts["K"])
