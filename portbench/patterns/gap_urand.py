"""The GAP Benchmark Suite's ``urand`` graph (Beamer, Asanovic and
Patterson, arXiv:1508.03619): an Erdos-Renyi graph on ``2**scale``
vertices with ``degree * 2**scale`` undirected edges drawn uniformly,
stored both ways (``2 * degree`` entries a row on average).  GAP drops
the few self-loops and repeated edges it draws; here they are drawn
again, so every seed gives exactly ``2 * degree * 2**scale`` entries."""

from __future__ import annotations

import torch


def make(cfg: dict, gen: torch.Generator, device) -> tuple:
    n = 2 ** cfg["scale"]
    edges = cfg["degree"] * n
    if 2 * edges > n * (n - 1) // 2:
        raise ValueError(f"gap_urand: {edges} edges is too dense for {n} "
                         f"vertices")
    draw = edges + edges // 16 + 64
    while True:
        u = torch.randint(0, n, (draw,), generator=gen, device=device)
        v = torch.randint(0, n, (draw,), generator=gen, device=device)
        lo, hi = torch.minimum(u, v), torch.maximum(u, v)
        keys = torch.unique((lo * n + hi)[lo != hi])
        if keys.numel() >= edges:
            break
        draw *= 2
    pick = torch.randperm(keys.numel(), generator=gen, device=device)[:edges]
    keys = keys[pick]
    lo, hi = keys // n, keys % n
    both = torch.sort(torch.cat([lo * n + hi, hi * n + lo])).values
    return both // n, both % n
