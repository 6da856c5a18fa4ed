"""PyTorch port on the card: the CUDA kernels against their plain
versions at awkward shapes, the main path (the Krylov solvers, the
implicit solves and the sparse multivariate normals too) against the
CPU, and the wrappers' refusals.

Every test needs an NVIDIA GPU and skips without one.  The file imports
nothing of JAX, so the card's machine, which has no JAX, runs it without
``tests/conftest.py``:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torchsparsegradutils_tpu_torch import (SparseCOO, SparseCSR, sddmm,
                                            sparse_bidir_logsumexp,
                                            sparse_generic_lstsq,
                                            sparse_generic_solve,
                                            sparse_logsumexp, sparse_mm,
                                            sparse_triangular_solve)
from torchsparsegradutils_tpu_torch import solvers as ps
from torchsparsegradutils_tpu_torch.kernels import _build, dia, row_packs
from torchsparsegradutils_tpu_torch.kernels import chunk_spmm as cs
from torchsparsegradutils_tpu_torch.kernels.chunk_lse import (
    LsePacks, lse_rows, lse_rows_bwd, lse_rows_bwd_plain, lse_rows_plain,
    pack_table)
from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
    build_chunk_plan, chunk_bwd_cols, chunk_bwd_cols_plain, chunk_sddmm,
    chunk_sddmm_plain, chunk_spmm, chunk_spmm_plain, chunk_spmv,
    chunk_spmv_plain)
from torchsparsegradutils_tpu_torch.kernels.dia import (sddmm_core,
                                                        sddmm_core_plain,
                                                        spmm_core,
                                                        spmm_core_plain)
from torchsparsegradutils_tpu_torch.kernels import dia_tri
from torchsparsegradutils_tpu_torch.kernels import window_gather as wg
from torchsparsegradutils_tpu_torch.kernels.dia_tri import (
    tri_dia_core, tri_dia_core_plain, tri_dia_inv)
from torchsparsegradutils_tpu_torch.kernels.window_gather import (
    window_gather, window_gather_plain)
from torchsparsegradutils_tpu_torch.models import (PairwiseEncoder,
                                                   SparseMultivariateNormal)
from torchsparsegradutils_tpu_torch.types import StaticArray
from torchsparsegradutils_tpu_torch.utils import coo_to_csr
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    hybrid_sparse, make_spd_sparse, make_spd_stencil, rand_sparse,
    rand_sparse_tri, stencil_sparse)
from torch_lse_patterns import (EDGE_ALL_NEG_INF, EDGE_PLUS_INF,
                                lse_pattern, pack_edge_pattern)

pytestmark = pytest.mark.cuda

# (rtol, atol as a fraction of max|ref|): sums run in another order
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-5),
       torch.float64: (1e-12, 1e-12)}
DTYPES = list(TOL)
# the cfd2 stencil of bench.py:44-46, and its 13 lower offsets (the
# tri-stencil)
CFD2_OFFSETS = sorted({0, 1, -1, 2, -2, 3, -3, 49, -49, 50, -50, 51, -51,
                       2401, -2401, 2449, -2449, 2450, -2450, 2451, -2451,
                       2499, -2499, 2500, -2500})
TRI_OFFSETS = [o for o in CFD2_OFFSETS if o <= 0]
# (n, m, p, offsets, lead): ``lead`` > 0 passes B, and X, as contiguous
# views that many elements into their storage, so their data pointers are
# not 16-byte aligned and K1 and K2 take their scalar tiles
SHAPES = [(1000, 1000, 1, [-3, 0, 3], 0),
          (777, 1200, 33, [-500, -1, 0, 7, 900], 0),
          (1300, 600, 130, [-1000, -5, 0, 2, 599], 0),
          (2000, 2000, 5, list(range(-128, 128)), 0),     # K = 256
          # windows crossing the 128- and 256-row tile edges, n % 128 != 0
          (1000, 1000, 128, [-130, -129, -2, 0, 1, 127, 129], 0),
          (1000, 900, 16, [-300, -257, -255, 0, 255, 257], 0),
          (900, 1100, 130, [-64, -3, -2, -1, 0, 1, 2, 3, 64], 0),
          (640, 700, 64, [-40, -1, 0, 1, 40], 1),           # unaligned B
          (500, 500, 8, [-3000, -1, 0, 1, 2900], 0),        # windows of holes
          (1500, 1300, 2, [-40, -2, -1, 0, 1, 2, 3, 4, 5, 40], 0),   # p = 2
          (6000, 6000, 128, TRI_OFFSETS, 0),                # the tri-stencil
          (6000, 6000, 2, TRI_OFFSETS, 1)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def close(got, ref, dtype):
    rtol, frac = TOL[dtype]
    ref = ref.double().cpu()
    torch.testing.assert_close(got.double().cpu(), ref, rtol=rtol,
                               atol=frac * ref.abs().max().item())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,p,offsets,lead", SHAPES)
def test_dia_kernels_match_plain(dev, dtype, n, m, p, offsets, lead):
    g = torch.Generator().manual_seed(n + p)
    K = len(offsets)
    offs = torch.tensor(offsets, device=dev)
    # values in the out-of-range cells too: both versions must skip them
    grid = torch.randn(n, K, generator=g).to(dev, dtype)
    B = torch.randn(lead + m * p, generator=g).to(dev, dtype)[lead:].view(
        m, p)
    assert B.is_contiguous() and (lead == 0 or B.data_ptr() % 16 != 0)
    X = torch.randn(lead + n * p, generator=g).to(dev, dtype)[lead:].view(
        n, p)
    before = spmm_core.launches, sddmm_core.launches
    close(spmm_core(offs, grid, B), spmm_core_plain(offs, grid, B), dtype)
    # K2 on X and B as given, then (unaligned) each of them alone
    pairs = [(X, B)] + ([(X, B.clone()), (X.clone(), B)] if lead else [])
    for x, y in pairs:
        close(sddmm_core(offs, x, y), sddmm_core_plain(offs, x, y), dtype)
    torch.cuda.synchronize()
    assert (spmm_core.launches, sddmm_core.launches) == (
        before[0] + 1, before[1] + len(pairs))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_spmm_repeats_bitwise_at_the_cfd2_stencil(dev, dtype):
    # bench.py's 25-offset stencil at N = 123,440, p = 128: three windows
    n = 123_440
    geo = dia.DiaGeometry(np.array(CFD2_OFFSETS), n, n)
    g = torch.Generator().manual_seed(7)
    grid = torch.randn(n, len(CFD2_OFFSETS), generator=g).to(dev, dtype)
    B = torch.randn(n, 128, generator=g).to(dev, dtype)
    offs = geo.offsets_on(dev)
    got = spmm_core(offs, grid, B, geo)
    assert torch.equal(got, spmm_core(offs, grid, B, geo))
    assert torch.equal(got, spmm_core(offs, grid, B))   # table from offs
    close(got, spmm_core_plain(offs, grid, B), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_sddmm_repeats_bitwise_at_the_cfd2_stencil(dev, dtype):
    # K2 at the stencil step's gradA: X = G, Y = B, N = 123,440, p = 128
    n = 123_440
    geo = dia.DiaGeometry(np.array(CFD2_OFFSETS), n, n)
    g = torch.Generator().manual_seed(8)
    X = torch.randn(n, 128, generator=g).to(dev, dtype)
    Y = torch.randn(n, 128, generator=g).to(dev, dtype)
    offs = geo.offsets_on(dev)
    got = sddmm_core(offs, X, Y, geo)
    assert torch.equal(got, sddmm_core(offs, X, Y, geo))
    assert torch.equal(got, sddmm_core(offs, X, Y))     # table from offs
    close(got, sddmm_core_plain(offs, X, Y), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_matches_plain_exactly(dev, dtype):
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.standard_normal(70_001)).to(dev, dtype)
    idx = rng.integers(-1, 70_001, 250_000)            # -1 marks holes
    idx = torch.from_numpy(idx).to(dev)
    before = window_gather.launches
    got = window_gather(src, idx)
    assert torch.equal(got, window_gather_plain(src, idx))
    assert window_gather.launches == before + 1


def _awkward_chunk_plan(transpose=False):
    """(n, m) = (700, 6000): every seventh row empty, row 5 dense with
    5,000 entries (longer than any block), the rest uniform random; with
    ``transpose`` the same entries with rows and columns swapped, (6000,
    700), so column 5 holds 5,000 entries and every seventh column is
    empty."""
    n, m = 700, 6000
    rng = np.random.default_rng(3)
    keys = np.sort(rng.choice(n * m, 20_000, replace=False))
    rows, cols = keys // m, keys % m
    keep = (rows % 7 != 0) & (rows != 5)
    rows = np.concatenate([rows[keep], np.full(5000, 5)])
    cols = np.concatenate([cols[keep], np.sort(rng.choice(m, 5000, False))])
    if transpose:
        rows, cols, n, m = cols, rows, m, n
    order = np.lexsort((cols, rows))
    return build_chunk_plan(StaticArray(rows[order]),
                            StaticArray(cols[order]), n, m)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [1, 3, 8, 16, 32, 33, 64, 128, 130, 260])
def test_chunk_kernels_match_plain_and_repeat_bitwise(dev, dtype, p):
    plan = _awkward_chunk_plan()
    g = torch.Generator().manual_seed(p)
    vals = torch.randn(plan.nnz, generator=g).to(dev, dtype)
    B = torch.randn(plan.m, p, generator=g).to(dev, dtype)
    X = torch.randn(plan.n, p, generator=g).to(dev, dtype)
    d, dt = plan.maps(dev), plan.T.maps(dev)
    vals_t = plan.to_T(vals)
    calls = [(chunk_spmm, chunk_spmm_plain, (d["indptr"], d["cols"], vals, B)),
             (chunk_spmm, chunk_spmm_plain,
              (dt["indptr"], dt["cols"], vals_t, X)),         # A^T X
             (chunk_sddmm, chunk_sddmm_plain, (d["indptr"], d["cols"], X, B))]
    if p == 1:
        calls.append((chunk_spmv, chunk_spmv_plain,
                      (d["indptr"], d["cols"], vals, B[:, 0])))
    for kern, plain, args in calls:
        before = kern.launches
        got = kern(*args)
        again = kern(*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        assert torch.equal(got, again), f"{kern.__name__} not repeatable"
        close(got, plain(*args), dtype)
    out = chunk_spmm(d["indptr"], d["cols"], vals, B)
    assert bool((out[::7] == 0).all())            # empty rows write 0


def _short_row_plan():
    """(3000, 2500): 2.5 entries a row on average (fewer than SHORT_ROW,
    so K6 and K7 take the four-line slab), every fifth row empty and row
    7 holding 300 entries."""
    n, m = 3000, 2500
    rng = np.random.default_rng(5)
    keys = np.sort(rng.choice(n * m, 7_000, replace=False))
    rows, cols = keys // m, keys % m
    keep = (rows % 5 != 0) & (rows != 7)
    rows = np.concatenate([rows[keep], np.full(300, 7)])
    cols = np.concatenate([cols[keep], np.sort(rng.choice(m, 300, False))])
    order = np.lexsort((cols, rows))
    plan = build_chunk_plan(StaticArray(rows[order]),
                            StaticArray(cols[order]), n, m)
    assert plan.nnz < cs.SHORT_ROW * n
    return plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [3, 16, 64, 128, 130])
def test_chunk_kernels_on_short_rows_match_plain(dev, dtype, p):
    plan = _short_row_plan()
    g = torch.Generator().manual_seed(p)
    vals = torch.randn(plan.nnz, generator=g).to(dev, dtype)
    B = torch.randn(plan.m, p, generator=g).to(dev, dtype)
    X = torch.randn(plan.n, p, generator=g).to(dev, dtype)
    d = plan.maps(dev)
    for kern, plain, args in (
            (chunk_spmm, chunk_spmm_plain, (d["indptr"], d["cols"], vals,
                                            B)),
            (chunk_sddmm, chunk_sddmm_plain, (d["indptr"], d["cols"], X,
                                              B))):
        before = kern.launches
        got, again = kern(*args), kern(*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        assert torch.equal(got, again), f"{kern.__name__} not repeatable"
        close(got, plain(*args), dtype)


@pytest.mark.parametrize("p", [64, 32, 16])
def test_chunk_kernels_take_unaligned_rows(dev, p):
    # p % 4 == 0 but a base 4 bytes off 16-byte alignment: the scalar path
    plan = _awkward_chunk_plan()
    d = plan.maps(dev)
    vals = torch.randn(plan.nnz, device=dev)
    B = torch.randn(plan.m * p + 1, device=dev)[1:].view(plan.m, p)
    X = torch.randn(plan.n * p + 1, device=dev)[1:].view(plan.n, p)
    close(chunk_spmm(d["indptr"], d["cols"], vals, B),
          chunk_spmm_plain(d["indptr"], d["cols"], vals, B), torch.float32)
    close(chunk_sddmm(d["indptr"], d["cols"], X, B),
          chunk_sddmm_plain(d["indptr"], d["cols"], X, B), torch.float32)


@pytest.mark.parametrize("kind", ["stencil", "hybrid", "random"])
def test_sparse_mm_on_card_matches_cpu(dev, kind):
    if kind == "stencil":
        A = stencil_sparse((3000, 2500), [-700, -1, 0, 1, 40], device="cpu")
    elif kind == "random":
        A = rand_sparse((3000, 2500), 30_000, layout="csr", device="cpu")
    else:
        A = hybrid_sparse((3000, 3000), [-50, -1, 0, 1, 50], 14_000,
                          dia_coverage=0.85, device="cpu")
    n, m = A.shape
    g = torch.Generator().manual_seed(2)
    B, G = torch.randn(m, 24, generator=g), torch.randn(n, 24, generator=g)
    X = torch.randn(n, 24, generator=g)

    def run(device):
        v = A.values.to(device).requires_grad_(True)
        b = B.to(device).requires_grad_(True)
        out = sparse_mm(A.with_data(v), b)
        gv, gb = torch.autograd.grad(out, (v, b), G.to(device),
                                     create_graph=True)
        hv, hb = torch.autograd.grad((gv ** 2).sum() + (gb ** 2).sum(),
                                     (v, b))
        s = sddmm(A.with_data(v), X.to(device), b).values
        return out, gv, gb, hv, hb, s

    for got, ref in zip(run(dev), run("cpu")):
        close(got.detach(), ref.detach(), torch.float32)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    offs = torch.tensor([0, 1], device=dev)
    x = torch.ones(8, 2, device=dev)
    with pytest.raises(ValueError, match="float32, bfloat16 or float64"):
        spmm_core(offs, x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        sddmm_core(offs, x.t(), x.t())
    with pytest.raises(ValueError, match="int64"):
        spmm_core(offs.int(), x, x)
    with pytest.raises(ValueError, match="K <= 256"):
        spmm_core(torch.arange(300, device=dev), torch.ones(8, 300,
                                                            device=dev), x)
    with pytest.raises(ValueError, match="CUDA device"):
        window_gather(x[:, 0], offs.cpu())
    before = spmm_core.launches
    assert spmm_core(offs, x, x[:, :0]).shape == (8, 0)
    assert spmm_core.launches == before          # nothing to launch


def test_chunk_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ip = torch.tensor([0, 1, 2], device=dev)
    x = torch.ones(2, 4, device=dev)
    with pytest.raises(ValueError, match="int64"):
        chunk_spmm(ip.int(), ip[:2], x[:, 0], x)
    with pytest.raises(ValueError, match="float32, bfloat16 or float64"):
        chunk_sddmm(ip, ip[:2], x.half(), x.half())
    with pytest.raises(ValueError, match="bad operand shapes"):
        chunk_spmv(ip, ip[:2], x[0, :2], x)
    with pytest.raises(ValueError, match="CUDA device"):
        chunk_spmm(ip, ip[:2].cpu(), x[0, :2], x)


def _spmv_edge_cases():
    """(indptr, m) at the edges of K8's row packs (T = SPMV_PACK = 512
    entries): the LSE pack edge pattern (rows of 256 and 257 entries, of
    1,024 to 4,097 (lone rows of several chunks), 2,048 entries in rows
    of 16 (full packs), 3,000 empty rows, every lane group; n > m), and
    rows of 256 and 257, a run of 1,500 empty rows, rows of 30 and 100
    entries whose packs end where the next row would straddle T, rows of
    2,047 and 2,049 (n < m)."""
    _, m, indptr, _ = pack_edge_pattern()
    lens = ([256, 257, 3] + [0] * 1500 + [30] * 200 + [100] * 50
            + [2047, 1, 2049, 2] + [7] * 300)
    return [(indptr, m),
            (np.concatenate([[0], np.cumsum(lens)]).astype(np.int64),
             200_000)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [0, 1])
def test_chunk_spmv_at_pack_edges(dev, dtype, case):
    indptr, m = _spmv_edge_cases()[case]
    n, nnz = len(indptr) - 1, int(indptr[-1])
    assert (n > m) == (case == 0)
    T = cs.SPMV_PACK
    starts = row_packs.lse_packs(indptr, T)
    ents = indptr[starts[1:]] - indptr[starts[:-1]]
    assert (np.diff(starts) == T // 2).any()            # rows cap a pack
    assert (ents[np.diff(starts) > 1] >= T - 2).any()   # full packs
    rng = np.random.default_rng(case)
    ip = torch.from_numpy(indptr).to(dev)
    cols = torch.from_numpy(rng.integers(0, m, nnz)).to(dev)
    vals = torch.from_numpy(rng.standard_normal(nnz)).to(dev, dtype)
    x = torch.from_numpy(rng.standard_normal(m)).to(dev, dtype)
    pk = pack_table(indptr, dev, T)
    before = chunk_spmv.launches
    y, again, built = (chunk_spmv(ip, cols, vals, x, p)
                       for p in (pk, pk, None))
    torch.cuda.synchronize()
    assert chunk_spmv.launches == before + 3
    assert y.dtype == dtype and y.shape == (n,)
    assert torch.equal(y, again) and torch.equal(y, built)
    assert bool((y[torch.from_numpy(np.diff(indptr) == 0).to(dev)] == 0
                 ).all())                              # empty rows write 0
    # the plain version in float64 on the same values
    close(y, chunk_spmv_plain(ip, cols, vals.double(), x.double()), dtype)


def test_chunk_spmv_refuses_a_pack_table_of_another_pattern(dev):
    ip = torch.tensor([0, 1, 3], device=dev)
    cols = torch.tensor([0, 1, 0], device=dev)
    v = torch.ones(3, device=dev)
    T = cs.SPMV_PACK
    before = chunk_spmv.launches
    with pytest.raises(ValueError, match="cut for 3 rows and 3 entries"):
        chunk_spmv(ip, cols, v, v[:2], pack_table(np.array([0, 1, 2, 3]),
                                                  dev, T))
    with pytest.raises(ValueError, match="cut for 2 rows and 4 entries"):
        chunk_spmv(ip, cols, v, v[:2], pack_table(np.array([0, 1, 4]), dev,
                                                  T))
    with pytest.raises(ValueError, match="packs must be"):
        chunk_spmv(ip, cols, v, v[:2], pack_table(np.array([0, 1, 3]),
                                                  "cpu", T))
    # the LSE kernels' table of the same pattern: cut at another size
    with pytest.raises(ValueError, match="cut at 2048 entries a pack"):
        chunk_spmv(ip, cols, v, v[:2], pack_table(np.array([0, 1, 3]), dev))
    assert chunk_spmv.launches == before


def test_sparse_mm_p1_on_card_runs_k8_over_cached_pack_tables(
        dev, monkeypatch):
    # the public p = 1 path: K8 twice a fwd+bwd step (A x, then Aᵀ g over
    # the transpose plan), over the plans' cached tables (no table built,
    # so no host copy, after the first step), its plain version never
    A = rand_sparse((3000, 2500), 30_000, layout="csr", device="cpu")
    g = torch.Generator().manual_seed(14)
    B, G = torch.randn(2500, 1, generator=g), torch.randn(3000, 1,
                                                          generator=g)
    built = []

    def plain(*args):
        raise AssertionError("chunk_spmv_plain ran on the card")
    monkeypatch.setattr(cs, "chunk_spmv_plain", plain)
    table = row_packs.pack_table
    monkeypatch.setattr(row_packs, "pack_table",
                        lambda *a, **k: built.append(1) or table(*a, **k))

    def run(device):
        v = A.values.to(device).requires_grad_(True)
        b = B.to(device).requires_grad_(True)
        out = sparse_mm(A.with_data(v), b)
        return (out, *torch.autograd.grad(out, (v, b), G.to(device)))

    got = []
    for step in range(2):
        before, tables = chunk_spmv.launches, len(built)
        got.append(run(dev))
        torch.cuda.synchronize()
        assert chunk_spmv.launches == before + 2
        assert len(built) - tables <= (2 if step == 0 else 0)
    monkeypatch.undo()
    for x, again, ref in zip(*got, run("cpu")):
        assert torch.equal(x, again)
        close(x, ref, torch.float32)


NB = dia_tri.KERNEL_NB   # the walk's row block
TP = 2                   # and its column tile (csrc/tri_dia.cu TP)
TRI_CASES = [
    (300, 1, [-130, -17, -3, 0], False),     # n not a multiple of 256, p = 1
    (500, 3, [-256, -1, 0, 5], False),       # span at a block boundary
    (777, 5, [-300, -2, -1, 7], True),       # unit; p not a multiple of 4
    (2000, 130, [-2500 + 2000 - 1, -51, -50, -1, 0, 1, 51], False),
    (1000, 2, list(range(-200, 1)), False),  # 200 offsets
    # the block walk's edges: n = 3 nb - 1, 3 nb, 3 nb + 1; span nb and
    # nb + 1 (in the block or the one before) and 2 nb + 1 (late against
    # early terms); offsets -(nb - 1) and -nb; p = TP - 1, TP, TP + 1;
    # unit with no offset 0
    (3 * NB - 1, TP - 1, [-NB, -(NB - 1), -2, -1, 0], False),
    (3 * NB, TP, [-(NB + 1), -NB, -1, 0], False),
    (3 * NB + 1, TP + 1, [-(NB + 1), -(NB - 1), -3, 0, 2], False),
    (5 * NB + 1, TP, [-NB, -7, -1], True),
    (4 * NB, 2 * TP + 1,
     [-(2 * NB + 1), -2 * NB, -(2 * NB - 1), -(NB + 1), -1, 0], False),
    # the walk without its shared-memory ring and grid rows (early terms
    # and grid values read from device memory): a band too wide for them
    # in float64; 201 offsets above, and the widest the kernel takes
    # (span SPAN_CAP, MAX_DIAGS offsets, 63 of them in the inverses) in
    # every dtype
    (9000, 3, [-8000, -4000, -1, 0], False),
    (9000, 2, [-8000] + list(range(-200, 1)), False),
    (8500, 3, [-dia_tri.SPAN_CAP] + list(range(-254, 1)), False)]


def tri_case(dev, dtype, n, p, offsets):
    """A diagonally dominant grid (the solve stays bounded) and B."""
    g = torch.Generator().manual_seed(n + p)
    grid = torch.randn(n, len(offsets), generator=g) * 0.1
    if 0 in offsets:
        k0 = offsets.index(0)
        grid[:, k0] = 1 + grid.abs().sum(1) - grid[:, k0].abs()
    return (grid.to(dev, dtype),
            torch.randn(n, p, generator=g).to(dev, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,p,offsets,unit", TRI_CASES)
def test_tri_dia_kernel_matches_plain_and_repeats_bitwise(dev, dtype, n, p,
                                                          offsets, unit):
    """K9 (block inverses, then the walk) against its plain version at
    the walk's row block."""
    grid, B = tri_case(dev, dtype, n, p, offsets)
    offs = np.array(offsets)
    before = tri_dia_core.launches, tri_dia_inv.launches
    got = tri_dia_core(offs, grid, B, unit=unit)
    again = tri_dia_core(offs, grid, B, unit=unit)
    torch.cuda.synchronize()
    assert (tri_dia_core.launches, tri_dia_inv.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    close(got, tri_dia_core_plain(offs, grid, B, unit=unit, nb=NB), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,p,offsets,unit", TRI_CASES[::2] + TRI_CASES[7:8])
def test_tri_dia_inv_matches_plain_and_repeats_bitwise(dev, dtype, n, p,
                                                       offsets, unit):
    """K9's block inverses against ``_build_diag_inv`` (zero above the
    diagonal, unit diagonal with ``unit`` and on the padded rows)."""
    grid, _ = tri_case(dev, dtype, n, p, offsets)
    offs = np.array(offsets)
    got = tri_dia_inv(offs, grid, unit=unit)
    assert torch.equal(got, tri_dia_inv(offs, grid, unit=unit))
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    assert got.shape == (-(-n // NB), NB, NB) and got.dtype == acc
    close(got, dia_tri._build_diag_inv(offs, grid, n, -(-n // NB), NB, unit,
                                       acc), dtype)


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("unit", [False, True])
def test_tri_solve_on_card_matches_cpu(dev, upper, transpose, unit):
    offs = [0, 1, 2, 49, 700] if upper else [-700, -49, -2, -1, 0]
    if unit:
        offs = [o for o in offs if o]
    A = stencil_sparse((1500, 1500), offs, well_conditioned=not unit,
                       device="cpu")
    if unit:
        A = A.with_data(A.values * 0.2)
    g = torch.Generator().manual_seed(4)
    B, G = torch.randn(1500, 6, generator=g), torch.randn(1500, 6, generator=g)

    def run(device):
        v = A.values.to(device).requires_grad_(True)
        b = B.to(device).requires_grad_(True)
        x = sparse_triangular_solve(A.with_data(v), b, upper=upper,
                                    unitriangular=unit, transpose=transpose)
        gv, gb = torch.autograd.grad(x, (v, b), G.to(device),
                                     create_graph=True)
        hv, = torch.autograd.grad((gv ** 2).sum() + (gb ** 2).sum(), v)
        return x, gv, gb, hv

    before = tri_dia_core.launches
    got = run(dev)
    torch.cuda.synchronize()
    assert tri_dia_core.launches - before >= 2       # forward and gradB
    for x, ref in zip(got, run("cpu")):
        close(x.detach(), ref.detach(), torch.float32)


def test_tri_solve_random_factor_on_card_matches_cpu(dev):
    A = rand_sparse_tri((3000, 3000), 15_000, layout="csr", device="cpu")
    g = torch.Generator().manual_seed(5)
    B, G = torch.randn(3000, 2, generator=g), torch.randn(3000, 2, generator=g)
    for algorithm in ("block", "wave"):
        def run(device):
            v = A.values.to(device).requires_grad_(True)
            b = B.to(device).requires_grad_(True)
            x = sparse_triangular_solve(A.with_data(v), b, upper=False,
                                        algorithm=algorithm)
            return (x, *torch.autograd.grad(x, (v, b), G.to(device)))
        for x, ref in zip(run(dev), run("cpu")):
            close(x, ref, torch.float32)


def test_tri_dia_wrapper_refuses_what_the_kernel_does_not_take(dev):
    offs = np.array([-1, 0])
    x = torch.ones(8, 2, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tri_dia_core(offs, x.t().contiguous().t(), x.t(), unit=False)
    with pytest.raises(ValueError, match="grid \\(n, K\\)"):
        tri_dia_core(offs, x[:4], x, unit=False)
    with pytest.raises(ValueError, match="CUDA device"):
        tri_dia_core(offs, x, x.cpu(), unit=False)


def close_inf(got, ref, dtype):
    """``close`` on the finite entries; the infinities equal."""
    got, ref = got.double().cpu(), ref.double().cpu()
    fin = torch.isfinite(ref)
    assert torch.equal(got[~fin], ref[~fin])
    close(got[fin], ref[fin], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("include_zeros", [False, True])
def test_lse_kernels_match_plain_and_repeat_bitwise(dev, dtype,
                                                    include_zeros):
    plan, vals = lse_pattern()
    ip = plan.maps(dev)["indptr"]
    v = torch.from_numpy(vals).to(dev, dtype)
    acc = _build.acc_dtype(dtype)
    g = torch.randn(plan.n, generator=torch.Generator().manual_seed(3)).to(
        dev, acc)
    before = lse_rows.launches, lse_rows_bwd.launches
    out, again = (lse_rows(ip, v, plan.m, include_zeros) for _ in range(2))
    # the plain versions in float64 on the same values: a float32
    # index_add over the 100,000-entry row drifts by about 1e-5 itself
    ref = lse_rows_plain(ip, v.double(), plan.m, include_zeros)
    d, d_again = (lse_rows_bwd(ip, v, out, g) for _ in range(2))
    torch.cuda.synchronize()
    assert (lse_rows.launches, lse_rows_bwd.launches) == (before[0] + 2,
                                                          before[1] + 2)
    assert out.dtype == acc and torch.equal(out, again)
    assert torch.equal(d, d_again)
    close_inf(out, ref, dtype)
    assert out[11] == float("inf")                     # a +inf entry
    assert (out[0] == float("-inf")) != include_zeros   # an empty row
    close(d, lse_rows_bwd_plain(ip, v.double(), out.double(), g.double()),
          dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lse_kernels_at_pack_edges(dev, dtype):
    # the plan's own lane groups: the pattern's packs pick G = 4, 8, 16
    # and 32 (tests/test_torch_lse.py holds the plan to that)
    n, m, indptr, vals = pack_edge_pattern()
    ip = torch.from_numpy(indptr).to(dev)
    v = torch.from_numpy(vals).to(dev, dtype)
    g = torch.randn(n, generator=torch.Generator().manual_seed(5)).to(
        dev, _build.acc_dtype(dtype))
    pk = pack_table(indptr, dev)
    for iz in (False, True):
        out = lse_rows(ip, v, m, iz, pk)
        d = lse_rows_bwd(ip, v, out, g, pk)
        torch.cuda.synchronize()
        assert torch.equal(out, lse_rows(ip, v, m, iz, pk))
        assert torch.equal(d, lse_rows_bwd(ip, v, out, g, pk))
        close_inf(out, lse_rows_plain(ip, v.double(), m, iz), dtype)
        assert (out[list(EDGE_PLUS_INF)] == float("inf")).all()
        assert ((out[list(EDGE_ALL_NEG_INF)] == float("-inf")) != iz).all()
        close(d, lse_rows_bwd_plain(ip, v.double(), out.double(),
                                    g.double()), dtype)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [3, 8, 33, 64, 128, 130, 260])
def test_fused_bwd_kernels_match_plain_and_repeat_bitwise(dev, dtype, p,
                                                          transpose):
    # p = 130 and 260 walk the columns in two or three slab groups
    plan = _awkward_chunk_plan(transpose)
    gen = torch.Generator().manual_seed(p)
    vals = torch.randn(plan.nnz, generator=gen).to(dev, dtype)
    B = torch.randn(plan.m, p, generator=gen).to(dev, dtype)
    G = torch.randn(plan.n, p, generator=gen).to(dev, dtype)
    d, dt = plan.maps(dev), plan.T.maps(dev)
    args = (dt["indptr"], dt["cols"], dt["perm"], dt["inv"], vals, B, G)
    for fast in (False, True):
        before = chunk_bwd_cols.launches
        (dd, dB), (dd2, dB2) = (chunk_bwd_cols(*args, fast)
                                for _ in range(2))
        torch.cuda.synchronize()
        assert chunk_bwd_cols.launches == before + 2
        assert torch.equal(dd, dd2) and torch.equal(dB, dB2)
        assert dd.dtype == dB.dtype == dtype and dB.shape == B.shape
        # dd is K7's arithmetic, bitwise
        assert torch.equal(dd, chunk_sddmm(d["indptr"], d["cols"], G, B))
        pdd, pdB = chunk_bwd_cols_plain(*args, fast)
        close(dd, pdd, dtype)
        close(dB, pdB, dtype)


@pytest.mark.parametrize("kind", ["stencil", "random", "skewed"])
def test_logsumexp_on_card_matches_cpu(dev, kind):
    if kind == "stencil":
        A = stencil_sparse((3000, 2500), [-700, -1, 0, 1, 40], device="cpu")
    elif kind == "random":
        A = rand_sparse((3000, 2500), 30_000, layout="csr", device="cpu")
    else:                       # hub rows of 1,250 entries: K10 and K11
        rng = np.random.default_rng(8)
        keys = np.sort(rng.choice(3000 * 2500, 20_000, replace=False))
        rows, cols = keys // 2500, keys % 2500
        hub = rows % 100 == 0
        rows = np.concatenate([rows[~hub]] + [np.full(1250, r) for r in
                                              range(0, 3000, 100)])
        cols = np.concatenate([cols[~hub]] + [np.sort(rng.choice(
            2500, 1250, False)) for _ in range(0, 3000, 100)])
        o = np.lexsort((cols, rows))
        A = SparseCOO(rows[o], cols[o], torch.from_numpy(rng.standard_normal(
            len(o)).astype(np.float32)), (3000, 2500)).tocsr()
    n, m = A.shape

    def run(device, backend):
        v = A.values.to(device).requires_grad_(True)
        M = A.with_data(v)
        outs = [sparse_logsumexp(M, 1, backend=backend),
                sparse_logsumexp(M, 0, include_zeros=False, backend=backend),
                *sparse_bidir_logsumexp(M, backend=backend)]
        cts = [torch.linspace(-1, 1, o.numel(), device=device) for o in outs]
        (gv,) = torch.autograd.grad(outs, v, cts, create_graph=True)
        (hv,) = torch.autograd.grad((gv ** 2).sum(), v)
        return [*outs, gv, hv]

    before = lse_rows.launches, lse_rows_bwd.launches
    got = run(dev, "auto")
    torch.cuda.synchronize()
    chunk = (lse_rows.launches - before[0], lse_rows_bwd.launches - before[1])
    assert (chunk[0] > 0 and chunk[1] > 0) == (kind == "skewed")
    for x, ref in zip(got, run("cpu", "xla")):
        close_inf(x.detach(), ref.detach(), torch.float32)


def test_sparse_mm_fused_on_card_matches_split(dev, monkeypatch):
    A = rand_sparse((3000, 2500), 30_000, layout="csr", device=dev)
    g = torch.Generator().manual_seed(6)
    B = torch.randn(2500, 24, generator=g).to(dev)
    G = torch.randn(3000, 24, generator=g).to(dev)

    def run(**kw):
        v = A.values.detach().clone().requires_grad_(True)
        b = B.clone().requires_grad_(True)
        out = sparse_mm(A.with_data(v), b, **kw)
        gv, gb = torch.autograd.grad(out, (v, b), G, create_graph=True)
        return [gv, gb, *torch.autograd.grad((gv ** 2).sum()
                                             + (gb ** 2).sum(), (v, b))]

    split = run()
    monkeypatch.setattr(dia, "SPMM_BWD", "fused")
    _no_plain(monkeypatch)
    before = chunk_bwd_cols.launches
    for gp in ("exact", "fast"):
        got = run(grad_precision=gp)
        close(got[0], split[0], torch.float32)
        if gp == "exact":
            for x, ref in zip(got[1:], split[1:]):
                close(x, ref, torch.float32)
        else:
            torch.testing.assert_close(got[1], split[1], rtol=3e-2,
                                       atol=3e-2)
    torch.cuda.synchronize()
    assert chunk_bwd_cols.launches == before + 2     # one a backward


@pytest.mark.parametrize("gp", ["exact", "fast"])
def test_hybrid_residual_fused_on_card_launches_k12_once(dev, monkeypatch,
                                                         gp):
    monkeypatch.setattr(dia, "RESID_ENGINE", "chunk")
    H = hybrid_sparse((3000, 3000), [-50, -1, 0, 1, 50], 30_000,
                      dia_coverage=0.8, generator=torch.Generator(
                          ).manual_seed(9), device=dev)
    g = torch.Generator().manual_seed(10)
    B = torch.randn(3000, 24, generator=g).to(dev)
    G = torch.randn(3000, 24, generator=g).to(dev)

    def run(**kw):
        v = H.values.detach().clone().requires_grad_(True)
        b = B.clone().requires_grad_(True)
        out = sparse_mm(H.with_data(v), b, **kw)
        return torch.autograd.grad(out, (v, b), G)

    split = run()
    monkeypatch.setattr(dia, "SPMM_BWD", "fused")
    _no_plain(monkeypatch)
    before = chunk_bwd_cols.launches
    got = run(grad_precision=gp)
    torch.cuda.synchronize()
    assert chunk_bwd_cols.launches == before + 1
    close(got[0], split[0], torch.float32)
    if gp == "exact":
        close(got[1], split[1], torch.float32)
    else:
        torch.testing.assert_close(got[1], split[1], rtol=3e-2, atol=3e-2)


def test_lse_and_fused_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ip = torch.tensor([0, 1, 2], device=dev)
    v = torch.ones(2, device=dev)
    with pytest.raises(ValueError, match="per-row tensors"):
        lse_rows_bwd(ip, v, torch.ones(2, device=dev, dtype=torch.float64),
                     torch.ones(2, device=dev))
    with pytest.raises(ValueError, match="float32, bfloat16 or float64"):
        lse_rows(ip, v.half(), 3, True)
    bad = LsePacks(torch.zeros(2, 3, dtype=torch.int64), 2, 2)   # on the CPU
    with pytest.raises(ValueError, match="packs must be"):
        lse_rows(ip, v, 3, True, bad)
    with pytest.raises(ValueError, match="packs must be"):
        lse_rows_bwd(ip, v, v, v, bad._replace(table=bad.table[:1].to(dev)))
    # a table cut for another pattern: the kernels would index out and d
    # past their ends
    other = pack_table(np.array([0, 1, 2, 3]), dev)
    with pytest.raises(ValueError, match="cut for 3 rows and 3 entries"):
        lse_rows(ip, v, 3, True, other)
    with pytest.raises(ValueError, match="cut for 2 rows and 3 entries"):
        lse_rows_bwd(ip, v, v, v, pack_table(np.array([0, 1, 3]), dev))
    x = torch.ones(2, 4, device=dev)
    c = ip[:2]
    with pytest.raises(ValueError, match="float32, bfloat16 or float64"):
        chunk_bwd_cols(ip, c, c, c, v, x.double(), x)
    with pytest.raises(ValueError, match="float32, bfloat16 or float64"):
        chunk_bwd_cols(ip, c, c, c, v.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="bad operand shapes"):
        chunk_bwd_cols(ip, c, c, c, v, x, torch.ones(2, 3, device=dev))
    with pytest.raises(ValueError, match="bad operand shapes"):
        chunk_bwd_cols(ip, c, c[:1], c, v, x, x)
    with pytest.raises(ValueError, match="bad operand shapes"):
        chunk_bwd_cols(ip, c, c, c[:1], v, x, x)
    with pytest.raises(ValueError, match="index tensors must be int64"):
        chunk_bwd_cols(ip, c.int(), c, c, v, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        chunk_bwd_cols(ip, c, c, c, v, x, torch.ones(4, 2, device=dev).t())
    with pytest.raises(ValueError, match="one CUDA device"):
        chunk_bwd_cols(ip.cpu(), c, c, c, v, x, x)


def test_wrappers_raise_on_cuda_when_the_build_is_missing(dev, monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "none")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.libraries.cache_clear()
    try:
        offs = torch.zeros(1, dtype=torch.int64, device=dev)
        x = torch.ones(4, 1, device=dev)
        for call in (lambda: spmm_core(offs, x, x),
                     lambda: sddmm_core(offs, x, x),
                     lambda: window_gather(x[:, 0], offs),
                     lambda: tri_dia_core(np.array([0]), x, x, unit=False),
                     lambda: lse_rows(offs[:1].repeat(2), x[:0, 0], 1, True),
                     lambda: chunk_bwd_cols(
                         torch.tensor([0, 1], device=dev), offs, offs, offs,
                         x[:1, 0], x[:1], x)):
            with pytest.raises(RuntimeError, match="nvcc"):
                call()
    finally:
        _build.libraries.cache_clear()


# --------------------------------------------------------------------------
# K13 (the row-slab SpMM) and the sharded chunk SpMM on a one-rank group
# --------------------------------------------------------------------------

def _slab_plan():
    """The awkward (700, 6000) pattern with rows 600 and up emptied: at 9
    shards (78 rows each) the last slab is empty and runs past n."""
    plan = _awkward_chunk_plan()
    keep = int(plan.indptr[600])
    rows = np.repeat(np.arange(plan.n), np.diff(plan.indptr))[:keep]
    return build_chunk_plan(StaticArray(rows), StaticArray(plan.cols[:keep]),
                            plan.n, plan.m)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slab_kernel_matches_plain_and_repeats_bitwise(dev, dtype):
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_spmm_slab, chunk_spmm_slab_plain)
    plan = _slab_plan()
    g = torch.Generator().manual_seed(13)
    vals = torch.randn(plan.nnz, generator=g).to(dev, dtype)
    B = torch.randn(plan.m, 3, generator=g).to(dev, dtype)
    d = plan.maps(dev)
    whole = chunk_spmm_plain(d["indptr"], d["cols"], vals, B)
    for row0, rps in [(78 * s, 78) for s in range(9)] + [(0, 700),
                                                        (702, 8), (0, 1)]:
        args = (d["indptr"], d["cols"], vals, B, row0, rps)
        before = chunk_spmm_slab.launches
        got, again = chunk_spmm_slab(*args), chunk_spmm_slab(*args)
        torch.cuda.synchronize()
        assert chunk_spmm_slab.launches == before + 2
        assert got.shape == (rps, 3) and torch.equal(got, again)
        close(got, chunk_spmm_slab_plain(*args), dtype)
        inside = max(0, min(rps, plan.n - row0))
        if inside:
            close(got[:inside], whole[row0:row0 + inside], dtype)
        assert not got[inside:].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_slab_kernel_rows_are_k6_rows_bitwise(dev, dtype):
    # row slabs that start, end or sit at the awkward plan's 5,000-entry
    # row 5, at widths that cross K6's column slabs (33 on the scalar
    # path, 64 on two-line slabs, 130 past a 128-column tile)
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_spmm_slab)
    plan = _awkward_chunk_plan()
    d = plan.maps(dev)
    g = torch.Generator().manual_seed(10)
    vals = torch.randn(plan.nnz, generator=g).to(dev, dtype)
    for p in (33, 64, 130):
        B = torch.randn(plan.m, p, generator=g).to(dev, dtype)
        whole = chunk_spmm(d["indptr"], d["cols"], vals, B)
        for row0, rps in ((5, 1), (0, 6), (5, 100), (4, 2), (699, 3)):
            got = chunk_spmm_slab(d["indptr"], d["cols"], vals, B, row0, rps)
            inside = max(0, min(rps, plan.n - row0))
            assert torch.equal(got[:inside], whole[row0:row0 + inside])
            assert not got[inside:].any()


def test_sharded_chunk_spmm_on_one_nccl_rank(dev, tmp_path):
    import torch.distributed as dist
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_spmm_slab)
    from torchsparsegradutils_tpu_torch.parallel import (
        build_sharded_chunk_plan, sharded_chunk_spmm)
    torch.cuda.set_device(torch.cuda.current_device())   # NCCL's card
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        A = rand_sparse((900, 700), 20_000, layout="csr",
                        generator=torch.Generator().manual_seed(5),
                        device=dev)
        B = torch.randn(700, 33, device=dev)
        G = torch.randn(900, 33, device=dev)
        plan = build_sharded_chunk_plan(A, 1)
        v, b = (A.values.clone().requires_grad_(True),
                B.clone().requires_grad_(True))
        before = chunk_spmm_slab.launches
        out = sharded_chunk_spmm(plan, v, b)
        gv, gb = torch.autograd.grad(out, (v, b), G)
        torch.cuda.synchronize()
        assert chunk_spmm_slab.launches == before + 1
        v2, b2 = (A.values.clone().requires_grad_(True),
                  B.clone().requires_grad_(True))
        ref = sparse_mm(A.with_data(v2), b2)
        rv, rb = torch.autograd.grad(ref, (v2, b2), G)
        for got, r in ((out, ref), (gv, rv), (gb, rb)):
            close(got, r, torch.float32)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the Krylov solvers and the implicit solve on the card
# --------------------------------------------------------------------------

# (rtol, atol): two iterative solves in float32 that sum in other orders,
# the JAX solver tests' float32 tolerance against a dense solve
SOLVE_TOL = (1e-3, 1e-4)


def _solver_matrix(route):
    """An SPD matrix of 3,000 rows on the DIA route (a stencil) or the
    chunk route (random rows), on the CPU."""
    if route == "dia":
        return make_spd_stencil(3000, [1, 60, 61], device="cpu")
    return make_spd_sparse(3000, 3000 + 2 * 12_000, layout="csr",
                           device="cpu")


def _no_plain(monkeypatch):
    def refuse(name):
        def plain(*a, **k):
            raise AssertionError(f"{name} ran on the card")
        return plain
    for mod, name in ((dia, "spmm_core_plain"), (dia, "sddmm_core_plain"),
                      (cs, "chunk_spmv_plain"), (cs, "chunk_spmm_plain"),
                      (cs, "chunk_sddmm_plain"),
                      (cs, "chunk_bwd_cols_plain")):
        monkeypatch.setattr(mod, name, refuse(name))


@pytest.mark.parametrize("route", ["dia", "chunk"])
@pytest.mark.parametrize("solver", ["linear_cg", "minres", "lsmr"])
def test_solvers_on_card_launch_their_matvec_and_match_cpu(
        dev, monkeypatch, route, solver):
    A = _solver_matrix(route)
    kernel = spmm_core if route == "dia" else chunk_spmv
    b = torch.randn(3000, generator=torch.Generator().manual_seed(15))

    def run(device):
        M, bb = A.with_data(A.values.to(device)), b.to(device)
        if solver == "lsmr":
            return ps.lsmr(M, bb, settings=ps.LSMRSettings(max_iter=100))[0]
        st = (ps.LinearCGSettings if solver == "linear_cg"
              else ps.MINRESSettings)(max_iter=100, rtol=1e-6)
        return getattr(ps, solver)(M, bb, settings=st)

    _no_plain(monkeypatch)
    before = kernel.launches
    got = run(dev)
    torch.cuda.synchronize()
    assert kernel.launches > before
    monkeypatch.undo()
    torch.testing.assert_close(got.cpu(), run("cpu"), rtol=SOLVE_TOL[0],
                               atol=SOLVE_TOL[1])


@pytest.mark.parametrize("route", ["dia", "chunk"])
def test_generic_solve_on_card_matches_cpu(dev, monkeypatch, route):
    A = _solver_matrix(route)
    g = torch.Generator().manual_seed(16)
    B, G = torch.randn(3000, 2, generator=g), torch.randn(3000, 2,
                                                          generator=g)

    def run(device):
        v = A.values.to(device).requires_grad_(True)
        b = B.to(device).requires_grad_(True)
        x = sparse_generic_solve(A.with_data(v), b, solve=ps.linear_cg,
                                 settings=ps.LinearCGSettings(rtol=1e-6))
        return (x, *torch.autograd.grad(x, (v, b), G.to(device)))

    _no_plain(monkeypatch)
    sddmm_kernel = sddmm_core if route == "dia" else chunk_sddmm
    before = sddmm_kernel.launches
    got = run(dev)
    torch.cuda.synchronize()
    assert sddmm_kernel.launches == before + 1        # gradA
    monkeypatch.undo()
    for x, ref in zip(got, run("cpu")):
        torch.testing.assert_close(x.cpu(), ref, rtol=SOLVE_TOL[0],
                                   atol=SOLVE_TOL[1])


def test_lstsq_on_card_matches_cpu(dev, monkeypatch):
    A = rand_sparse((4000, 2000), 30_000, layout="csr", device="cpu")
    g = torch.Generator().manual_seed(17)
    B, G = torch.randn(4000, generator=g), torch.randn(2000, generator=g)

    def run(device):
        v = A.values.to(device).requires_grad_(True)
        b = B.to(device).requires_grad_(True)
        x = sparse_generic_lstsq(A.with_data(v), b)
        return (x, *torch.autograd.grad(x, (v, b), G.to(device)))

    _no_plain(monkeypatch)
    before = chunk_spmv.launches
    got = run(dev)
    torch.cuda.synchronize()
    assert chunk_spmv.launches > before
    monkeypatch.undo()
    for x, ref in zip(got, run("cpu")):
        torch.testing.assert_close(x.cpu(), ref, rtol=5e-2, atol=5e-3)


# --------------------------------------------------------------------------
# the sparse multivariate normals (K1, K2, K3, K9) and coo_to_csr (K3)
# --------------------------------------------------------------------------

# (covariance?, LDLᵀ?) of the four parameterisations
MODEL_FORMS = {"cov_llt": (True, False), "cov_ldlt": (True, True),
               "prec_llt": (False, False), "prec_ldlt": (False, True)}


def _no_plain_models(monkeypatch):
    """No plain version of K1, K2, K3, K6, K7, K8 or K9 may run."""
    _no_plain(monkeypatch)
    for mod, name in ((dia_tri, "tri_dia_core_plain"),
                      (wg, "window_gather_plain")):
        def plain(*a, _name=name, **k):
            raise AssertionError(f"{_name} ran on the card")
        monkeypatch.setattr(mod, name, plain)


def _model_factor(ldlt):
    """The flagship encoder's factor on a 12³ volume (n = 1,728): strictly
    lower for LDLᵀ, with its diagonal stored (1 + 0.1 U(0, 1)) for LLᵀ;
    off-diagonal values 0.05 N(0, 1)."""
    enc = PairwiseEncoder(1.5, (1, 12, 12, 12), diag=not ldlt, upper=False,
                          layout="coo")
    g = torch.Generator().manual_seed(18)
    vals = 0.05 * torch.randn((len(enc.offsets),) + enc.volume_shape,
                              generator=g)
    for k, off in enumerate(enc.offsets):
        if not any(off):
            vals[k] = 1.0 + 0.1 * torch.rand(enc.volume_shape, generator=g)
    return enc(vals)


@pytest.mark.parametrize("form", list(MODEL_FORMS))
def test_distribution_on_card_matches_cpu(dev, monkeypatch, form):
    """Samples (``_transform_eps`` on one ε) and ``log_prob``, forward
    and backward, on the card against the CPU: the covariance samples
    launch K1, the precision samples and the covariance ``log_prob``
    K9, the gradients K2; no plain version runs."""
    cov, ldlt = MODEL_FORMS[form]
    L = _model_factor(ldlt)
    n = L.shape[-1]
    g = torch.Generator().manual_seed(19)
    loc = torch.randn(n, generator=g)
    D = torch.exp(0.2 * torch.randn(n, generator=g))
    eps = torch.randn(8, n, generator=g)
    value = loc + torch.randn(8, n, generator=g)

    def run(device):
        leaves = [t.to(device).requires_grad_(True)
                  for t in (L.values, loc, D)][:3 if ldlt else 2]
        kw = {"scale_tril" if cov else "precision_tril":
              L.with_data(leaves[0])}
        d = SparseMultivariateNormal(leaves[1], leaves[2] if ldlt else None,
                                     **kw)
        x = leaves[1] + d._transform_eps(eps.to(device))
        lp = d.log_prob(value.to(device))
        return (x, lp, *torch.autograd.grad((x ** 2).sum() + lp.sum(),
                                            leaves))

    _no_plain_models(monkeypatch)
    before = {f: f.launches for f in (spmm_core, sddmm_core, tri_dia_core)}
    got = run(dev)
    torch.cuda.synchronize()
    launched = {f.__name__: f.launches - b for f, b in before.items()}
    assert launched["sddmm_core"] > 0
    assert launched["spmm_core" if cov else "tri_dia_core"] > 0
    if cov:
        assert launched["tri_dia_core"] > 0        # log_prob's solve
    s = SparseMultivariateNormal(
        loc.to(dev), D.to(dev) if ldlt else None,
        **{"scale_tril" if cov else "precision_tril": L.with_data(
            L.values.to(dev))}).rsample(
        (4,), generator=torch.Generator(device=dev).manual_seed(0))
    assert s.shape == (4, n) and torch.isfinite(s).all()
    monkeypatch.undo()
    for x, ref in zip(got, run("cpu")):
        close(x.detach(), ref.detach(), torch.float32)


def test_coo_to_csr_on_card_permutes_through_the_gather(dev, monkeypatch):
    """coo_to_csr moves the values through K3, forward and backward (the
    gather by the inverse permutation), bitwise as on the CPU."""
    A = rand_sparse((2000, 1500), 20_000, device="cpu")
    perm = np.random.default_rng(0).permutation(A.nnz)
    U = SparseCOO(A.rows()[perm], A.cols()[perm], A.values[perm], A.shape)
    w = torch.randn(A.nnz, generator=torch.Generator().manual_seed(20))

    def run(device):
        v = U.values.to(device).requires_grad_(True)
        C = coo_to_csr(U.with_data(v))
        (gv,) = torch.autograd.grad((C.values * w.to(device)).sum(), v)
        return C.values, gv

    _no_plain_models(monkeypatch)
    before = window_gather.launches
    got = run(dev)
    torch.cuda.synchronize()
    assert window_gather.launches == before + 2
    monkeypatch.undo()
    for x, ref in zip(got, run("cpu")):
        assert torch.equal(x.detach().cpu(), ref.detach())


# --------------------------------------------------------------------------
# the ELL engine, distributed solves, explain and interop on the card
# --------------------------------------------------------------------------

# explain's kernel labels -> the wrappers whose ``launches`` count them
LABELS = {"K1": (dia, "spmm_core"), "K2": (dia, "sddmm_core"),
          "K3": (wg, "window_gather"), "K6": (cs, "chunk_spmm"),
          "K7": (cs, "chunk_sddmm"), "K8": (cs, "chunk_spmv"),
          "K9": (dia_tri, "tri_dia_core")}


def _launched(before):
    torch.cuda.synchronize()
    return {k for k, (mod, name) in LABELS.items()
            if getattr(mod, name).launches > before[k]}


def _launch_counts():
    return {k: getattr(mod, name).launches for k, (mod, name) in
            LABELS.items()}


@pytest.mark.parametrize("kind", ["stencil", "random", "skewed"])
def test_ell_on_card_launches_the_gather_and_matches_cpu(dev, monkeypatch,
                                                         kind):
    """``backend="ell"``: K3 launches for the value relayouts, no plain
    version runs, and the values and gradients are the CPU's."""
    plain = []
    real = wg.window_gather_plain
    monkeypatch.setattr(wg, "window_gather_plain",
                        lambda *a: plain.append(1) or real(*a))
    g = torch.Generator().manual_seed(31)
    if kind == "stencil":
        A = stencil_sparse((3000, 3000), [-50, -1, 0, 1, 50], generator=g,
                           device="cpu")
    elif kind == "random":
        A = rand_sparse((3000, 2500), 40_000, layout="csr", generator=g,
                        device="cpu")
    else:       # a hub row: the row plan is refused, the column plan kept
        rows = np.concatenate([np.zeros(2000, np.int64), np.arange(3000)])
        cols = np.concatenate([np.arange(2000), np.arange(3000) % 2500])
        A = SparseCOO(rows, cols, torch.randn(5000, generator=g),
                      (3000, 2500))
    B = torch.randn(A.shape[1], 33, generator=g)
    G = torch.randn(A.shape[0], 33, generator=g)
    out = []
    for d in ("cpu", dev):
        plain.clear()           # the CPU reference runs the plain version
        v = A.values.to(d).requires_grad_(True)
        b = B.to(d).requires_grad_(True)
        before = wg.window_gather.launches
        y = sparse_mm(A.with_data(v), b, backend="ell")
        gv, gb = torch.autograd.grad(y, (v, b), G.to(d))
        out.append((y, gv, gb))
        if d == dev:
            torch.cuda.synchronize()
            # the grids of the forward and gradB and gradA's way back;
            # skewed: only gradB's, over the column plan
            assert wg.window_gather.launches - before == (
                1 if kind == "skewed" else 3)
    assert not plain
    for got, ref in zip(out[1], out[0]):
        close(got, ref, torch.float32)


@pytest.mark.parametrize("solver", ["linear_cg", "minres", "bicgstab",
                                    "lsmr"])
def test_distributed_solve_on_one_nccl_rank_is_bitwise_plain(dev, tmp_path,
                                                             solver):
    """``matvec_closures`` on a one-rank NCCL group: each driver reads the
    closure's group and all-reduces its column sums, and its solve is
    bitwise the same closures' solve without a group."""
    import torch.distributed as dist
    from torchsparsegradutils_tpu_torch.parallel import matvec_closures
    from torchsparsegradutils_tpu_torch.solvers.common import group_sum
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        A = make_spd_stencil(8192, [-64, -1, 0, 1, 64],
                             generator=torch.Generator().manual_seed(32),
                             device=dev)
        mv, mv_t = matvec_closures(A)
        rhs = torch.randn(8192, 2, generator=torch.Generator().manual_seed(
            33)).to(dev)
        fn = getattr(ps, solver)
        kw = {"rmatvec": mv_t} if solver == "lsmr" else {}
        plain = ({"rmatvec": lambda x: mv_t(x)} if solver == "lsmr" else {})
        calls = group_sum.calls
        got = fn(mv, rhs, **kw)
        assert group_sum.calls > calls
        ref = fn(lambda x: mv(x), rhs, **plain)
        got, ref = (got[0], ref[0]) if solver == "lsmr" else (got, ref)
        assert torch.equal(got, ref)
        res = (sparse_mm(A, got) - rhs).norm() / rhs.norm()
        assert res.item() < 1e-4
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind,p", [("stencil", 16), ("random", 16),
                                    ("random", 1), ("hybrid", 16),
                                    ("tri", 2)])
def test_explain_names_the_kernels_the_route_launches(dev, kind, p):
    from torchsparsegradutils_tpu_torch import explain
    g = torch.Generator().manual_seed(34)
    if kind == "stencil":
        A = stencil_sparse((5000, 5000), [-70, -1, 0, 1, 70], generator=g,
                           device=dev)
    elif kind == "random":
        A = rand_sparse((5000, 5000), 60_000, layout="csr", generator=g,
                        device=dev)
    elif kind == "hybrid":
        A = hybrid_sparse((5000, 5000), [-70, -1, 0, 1, 70], 40_000,
                          dia_coverage=0.85, generator=g, device=dev)
    else:
        A = stencil_sparse((5000, 5000), [-70, -1, 0],
                           well_conditioned=True, generator=g, device=dev)
    rep = explain(A, p=p)
    B = torch.randn(5000, p, generator=g).to(dev)
    for op, run in (("sparse_mm", lambda v, b: sparse_mm(A.with_data(v), b)),
                    ("sddmm", lambda v, b: sddmm(A, b, b).values)):
        v = A.values.clone().requires_grad_(True)
        b = B.clone().requires_grad_(True)
        before = _launch_counts()
        run(v, b).sum().backward()
        assert _launched(before) == set(rep[op]["kernels"]), (op, rep[op])
    if kind == "tri":
        before = _launch_counts()
        sparse_triangular_solve(A, B)
        assert rep["triangular_solve"]["engine"] == "dia"
        assert {"K9", "K3"} <= _launched(before)


def test_torch_sparse_front_end_on_card_is_bitwise_sparse_mm(dev):
    from torchsparsegradutils_tpu_torch.interop import (from_torch_csr,
                                                        sparse_mm_torch)
    A = rand_sparse((3000, 2500), 40_000, layout="csr",
                    generator=torch.Generator().manual_seed(35), device=dev)
    B = torch.randn(2500, 33, device=dev)
    out = []
    for front in (True, False):
        v = A.values.clone().requires_grad_(True)
        b = B.clone().requires_grad_(True)
        crow = torch.from_numpy(A.indptr_np().astype(np.int64)).to(dev)
        t = torch.sparse_csr_tensor(crow, A.cols_t(), v, A.shape)
        y = sparse_mm_torch(t, b) if front else sparse_mm(from_torch_csr(t),
                                                          b)
        gv, gb = torch.autograd.grad(y, (v, b), torch.ones_like(y))
        out.append((y, gv, gb))
    assert all(torch.equal(a, b_) for a, b_ in zip(*out))


@pytest.mark.parametrize("method", ["spsolve", "cg"])
def test_scipy_solve_on_card_runs_grad_a_on_the_kernels(dev, method):
    from torchsparsegradutils_tpu_torch.interop import sparse_solve_scipy
    A = make_spd_stencil(4000, [-40, -1, 0, 1, 40],
                         generator=torch.Generator().manual_seed(36),
                         device=dev)
    b = torch.randn(4000, device=dev)
    v = A.values.clone().requires_grad_(True)
    before = _launch_counts()
    x = sparse_solve_scipy(A.with_data(v), b, method=method)
    (x ** 2).sum().backward()
    assert x.device == b.device and {"K2", "K3"} <= _launched(before)
    res = (sparse_mm(A, x[:, None])[:, 0] - b).norm() / b.norm()
    assert res.item() < 1e-4
    gb = sparse_solve_scipy(A, 2 * x.detach(), method=method)
    close(v.grad, -(gb[A.rows_t()] * x.detach()[A.cols_t()]), torch.float32)


# --------------------------------------------------------------------------
# device-resident (dynamic) patterns
# --------------------------------------------------------------------------

def test_dynamic_ops_on_card_make_no_host_sync(dev):
    """A dynamic pattern on the card: ``sparse_mm`` fwd+bwd, ``sddmm``
    and both LSE ops fwd+bwd run with no host sync (the sync debug mode
    raises on one) and launch no kernel, and match the static container
    on its default engine."""
    A = rand_sparse((3000, 2000), 30_000, layout="csr", device=dev)
    D = SparseCSR(torch.from_numpy(A.indptr_np().copy()).to(dev),
                  A.cols_t(), A.values, A.shape, pattern_static=False)
    gen = torch.Generator().manual_seed(21)
    B = torch.randn(2000, 16, generator=gen).to(dev)
    G = torch.randn(3000, 16, generator=gen).to(dev)

    def run(M):
        v = M.values.clone().requires_grad_(True)
        b = B.clone().requires_grad_(True)
        out = sparse_mm(M.with_data(v), b)
        c, r = sparse_bidir_logsumexp(M.with_data(v))
        grads = torch.autograd.grad((out * G).sum() + c.sum() + r.sum(),
                                    (v, b))
        return (out, c, r, sddmm(M, G, B).values) + grads

    torch.cuda.synchronize()
    before = _launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(D)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not _launched(before)
    for x, ref in zip(got, run(A)):
        close(x.detach(), ref.detach(), torch.float32)


def test_dynamic_tocsr_on_card_launches_the_gather(dev, monkeypatch):
    """A dynamic COO to CSR on the card: the sort and ``indptr`` on the
    device with no host sync, the values through K3 forward and
    backward (no plain version), bitwise the static ``coo_to_csr``."""
    A = rand_sparse((2000, 1500), 20_000, device="cpu")
    perm = np.random.default_rng(1).permutation(A.nnz)
    rows, cols = A.rows()[perm], A.cols()[perm]
    w = torch.randn(A.nnz, generator=torch.Generator().manual_seed(22))
    vals = A.values[perm]

    def run(U):
        v = U.values.requires_grad_(True)
        C = coo_to_csr(U.with_data(v))
        (gv,) = torch.autograd.grad((C.values * w.to(v.device)).sum(), v)
        first = C.indptr.cpu() if not C.pattern_static else \
            torch.from_numpy(C.indptr_np().copy())
        return first, C.cols_t().cpu(), C.values.cpu(), gv.cpu()

    D = SparseCOO(torch.from_numpy(rows).to(dev),
                  torch.from_numpy(cols).to(dev), vals.to(dev), A.shape,
                  pattern_static=False)
    _no_plain_models(monkeypatch)
    wd, v = w.to(dev), D.values.clone().requires_grad_(True)
    torch.cuda.synchronize()
    before = window_gather.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        C = coo_to_csr(D.with_data(v))
        torch.autograd.grad((C.values * wd).sum(), v)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert window_gather.launches == before + 2
    monkeypatch.undo()
    got = run(D.with_data(D.values.clone()))
    ref = run(SparseCOO(rows, cols, vals.clone(), A.shape))
    for x, r in zip(got, ref):
        assert torch.equal(x, r)
