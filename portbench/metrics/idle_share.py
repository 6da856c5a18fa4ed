"""Percent of the profiled stretch in which no operation ran on the
device."""


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
