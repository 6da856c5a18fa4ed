"""One reader per per-layer metric, found by the metric's name.

Each module's ``read(ctx)`` returns the metric's value from the traced
run, or None where it finds nothing to read (the harness then leaves the
metric out).  ``ctx`` holds ``trace`` (:func:`portbench.trace.parse`),
``shape`` (:func:`portbench.steps.shape_of`), ``enqueue_ms`` (host time
of each step's calls, one step at a time on an idle device),
``first_call_s`` (the first step on the fresh pattern minus the median
warm step, or None) and ``step_ms`` (the traced run's window).
"""
