"""The share of the AR kernel's ring bytes that live in a global ring (the
cluster kernel's wide form) rather than in shared memory, from the program's `ar_kernel.ring_bytes` counter over the
run's launches; nothing where every ring stayed in shared memory or the
program keeps no such counter."""
KIND, UNIT, SOURCE = "per_layer", "%", "program_counter"
LAYER = "AR kernel"
MOVES = "decode_audio_s_per_s"


def read(rec, ctx):
    if rec.kind != "offline" or rec.trace is None:
        return None
    from shallow_wavenet_tpu_torch.ops import ar_kernel
    counts = getattr(ar_kernel, "ring_bytes", None)
    if not counts or not counts["global"]:
        return None
    return 100.0 * counts["global"] / (counts["shared"] + counts["global"])
