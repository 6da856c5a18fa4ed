"""Host milliseconds to enqueue one step's calls (op, grad, update),
median over steps each started on an idle device: the public ops' host
cost, which sets ``step_ms`` where the card waits for the host."""

import statistics


def read(ctx):
    times = ctx.get("enqueue_ms")
    return statistics.median(times) if times else None
