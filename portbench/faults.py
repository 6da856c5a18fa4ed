"""Faults planted under the timed path, for the checks' own tests and
for reading the limits' upper ends on the card.

Each fault breaks :class:`portbench.steps.Program` where a real fault
would sit: ``frozen`` returns the step's state unchanged; ``half`` leaves
out half of B's columns (the step's batch of right-hand sides) and
stands the half it computed in for the rest; ``altered`` zeroes one row
of the op's output (one answer) where it is produced.
"""

from __future__ import annotations

import contextlib

import torch

from . import steps

KINDS = ("frozen", "half", "altered")


@contextlib.contextmanager
def planted(kind: str, seed: int = 0):
    forward, update = steps.Program.forward, steps.Program.update
    if kind == "frozen":
        def frozen(self, v, gv, b, gb):
            return None
        steps.Program.update = frozen
    elif kind == "half":
        def half(self, A, b):
            out = forward(self, A, b[:, :b.shape[1] // 2].contiguous())
            return torch.cat([out, out], 1)
        steps.Program.forward = half
    elif kind == "altered":
        def altered(self, A, b):
            out = forward(self, A, b)
            row = steps.derive(seed, "altered") % out.shape[0]
            return out.index_fill(0, torch.tensor([row], device=out.device),
                                  0.0)
        steps.Program.forward = altered
    else:
        raise ValueError(f"no fault {kind!r}; one of {KINDS}")
    try:
        yield
    finally:
        steps.Program.forward, steps.Program.update = forward, update
