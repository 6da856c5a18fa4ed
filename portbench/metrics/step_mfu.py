"""The whole step's share of the card's peak: the least time of the
step's work (count.step: each input read once, each output written once,
at 3.35 TB/s or 67 TFLOP/s) over ``step_ms`` of the same run's measured
window, on the host clock."""

from .. import count


def read(ctx):
    return 100.0 * count.least_s(*count.step(ctx["shape"])) * 1e3 \
        / ctx["step_ms"]
