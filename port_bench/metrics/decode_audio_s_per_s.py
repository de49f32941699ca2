"""Offline decode throughput: audio seconds of every completed
`decode_batch` call (each utterance at its own trimmed length) over the
time from the window's first call to its last call's end."""
KIND, UNIT, SOURCE = "end_to_end", "audio-s/s", "host_clock"


def read(rec, ctx):
    if rec.kind != "offline":
        return None
    return rec.facts["audio_s"] / rec.window_s
