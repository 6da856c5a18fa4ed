"""Device kernels a step launches, the port's and torch's alike, from the
profiler's trace."""


def read(ctx):
    t = ctx["trace"]
    return sum(n for n, _ in t["kernels"].values()) / t["steps"]
