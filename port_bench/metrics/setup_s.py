"""Set-up: from the process's start to the window's opening (imports,
weights, kernel builds and loads, warm-up)."""
KIND, UNIT, SOURCE = "end_to_end", "s", "host_clock"


def read(rec, ctx):
    return ctx.setup_s
