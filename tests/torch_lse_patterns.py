"""Row patterns at the edges of the chunk LSE kernels' pack plan
(``kernels/chunk_lse.py``), shared by the CPU tests of the plan
(``test_torch_lse.py``) and the card tests of the kernels
(``test_torch_cuda.py``).  Imports nothing of JAX and needs no card."""

import numpy as np

from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
    build_chunk_plan)
from torchsparsegradutils_tpu_torch.types import StaticArray


def lse_pattern():
    """(plan, values) of a (3000, 200_000) pattern: empty rows, a single
    entry, rows of 1,024 and 1,025 entries (packs of their own, walked by
    the whole block), one row of 100,000 (49 chunks of the pack size),
    the rest uniform; values with +inf, -inf and an all -inf row."""
    n, m = 3000, 200_000
    rng = np.random.default_rng(11)
    keys = np.sort(rng.choice(n * 50, 20_000, replace=False))
    rows, cols = keys // 50, keys % 50
    keep = (rows % 9 != 0) & ~np.isin(rows, [5, 6, 7, 8])
    extra = [(5, 100_000), (6, 1024), (7, 1025), (8, 1)]
    rows = np.concatenate([rows[keep]] + [np.full(k, r) for r, k in extra])
    cols = np.concatenate([cols[keep]] + [np.sort(rng.choice(m, k, False))
                                          for _, k in extra])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = rng.standard_normal(len(rows)) * 3
    vals[rows == 10] = -np.inf                      # an all -inf row
    vals[np.flatnonzero(rows == 11)[:1]] = np.inf
    vals[np.flatnonzero(rows == 12)[:1]] = -np.inf
    vals[np.flatnonzero(rows == 5)[::997]] = -np.inf
    return build_chunk_plan(StaticArray(rows), StaticArray(cols), n, m), vals


# rows of the pack edge pattern that its tests read
EDGE_PLUS_INF = (1, 13)        # a light row's +inf; +inf in a row of T
EDGE_ALL_NEG_INF = (3, 20)     # all -inf: a light row; a row of its own


def pack_edge_pattern():
    """(n, m, indptr, values) at the pack loop's edges, for T = 2,048:
    rows of 1,024, 1,025, 2,048, 2,049, 4,096 and 4,097 entries (one
    chunk, T and T + 1, 2 T and 2 T + 1), of 256 and 257 (a pack of its
    own above 256), exactly T entries in 128 rows of 16, a run of 3,000
    empty rows (several packs of empty rows at T / 2 rows a pack), rows
    of 40 and 200 and one of 1,000 among 1-entry rows; packs of rows of
    about 24, 48 and 100 entries, whose means pick lane groups of 8, 16
    and 32, with a row of 70 among the 24s and one of 200 among the 48s
    (a warp takes a row longer than 8 G in a pack of several); a short
    last pack, and n much larger than the entries at the end; +inf and
    -inf inside lane groups and across them, an all -inf light row and
    an all -inf row of its own."""
    rng = np.random.default_rng(17)
    m = 5000
    lens = ([5, 3, 0, 7, 4, 12, 9, 0, 2, 6]
            + [1024, 3, 1025, 2048, 0, 2049, 4096, 1, 4097, 256, 257]
            + [16] * 128 + [0] * 3000 + [1, 1, 40, 1, 200, 1, 1000, 1, 1]
            + [24] * 40 + [70] + [24] * 44 + [48] * 20 + [200] + [48] * 21
            + [100] * 20
            + [int(x) for x in rng.integers(0, 30, 300)] + [0] * 20_000
            + [2, 0, 5])
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    vals = rng.standard_normal(int(indptr[-1])) * 3
    row = lambda r: slice(indptr[r], indptr[r + 1])
    vals[indptr[1] + 1] = np.inf                    # a light row's +inf
    vals[row(3)] = -np.inf                          # an all -inf light row
    vals[row(15)][::7] = -np.inf                    # in a row of 2,049
    vals[row(20)] = -np.inf                         # all -inf, its own pack
    vals[row(13)][5] = np.inf                       # +inf in a row of T
    r200 = 10 + 11 + 128 + 3000 + 4
    vals[row(r200)][::3] = -np.inf                  # -inf in a warp's row
    return len(lens), m, indptr, vals
