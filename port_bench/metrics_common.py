"""Arithmetic shared by metric readers."""

from port_bench import yardstick


def roofline_pct(rec, kind: str):
    """Sum over the traced `ar_kernel.generate` calls of their least time
    (`yardstick.ar_bound_ms` at each call's rows and steps, the steps each
    row ran where the call passed `lengths`, in its weight dtype) over the
    device time of what they launched, in percent."""
    if rec.kind != kind or rec.trace is None:
        return None
    calls = [c for c in rec.trace.generate_calls if c["device_s"] > 0]
    if not calls:
        return None
    mc = rec.facts["model"]
    bound = sum(yardstick.ar_bound_ms(
        mc, *c["shape"], 2 if c["dtype"] == "bfloat16" else 4,
        c["dtype"], c["lengths"])[0] for c in calls)
    return 100.0 * bound / (1e3 * sum(c["device_s"] for c in calls))


def untraced_idle_pct(rec, kind: str):
    """The device's idle share of the untraced window of a host-bound
    path: the traced stretch's device busy time per unit of work (an
    update, a launch) times the units the untraced window did, over its
    length, in percent. The device's time per unit does not change under
    the profiler; the host's does, by the profiler's cost per operation,
    so the traced stretch's own idle share reads high on these paths."""
    if rec.kind != kind or rec.trace is None:
        return None
    traced, units, seconds = rec.facts["idle_units"]
    if traced <= 0 or units <= 0 or seconds <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / traced * units / seconds)
