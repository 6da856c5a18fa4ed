"""PyTorch port on the card: the CUDA kernels against their plain
versions at awkward shapes, the main path against the CPU, and the
wrappers' refusals.

Every test needs an NVIDIA GPU and skips without one.  The file imports
nothing of JAX, so the card's machine, which has no JAX, runs it without
``tests/conftest.py``:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torchsparsegradutils_tpu_torch import (SparseCOO, sddmm,
                                            sparse_bidir_logsumexp,
                                            sparse_logsumexp, sparse_mm,
                                            sparse_triangular_solve)
from torchsparsegradutils_tpu_torch.kernels import _build, dia
from torchsparsegradutils_tpu_torch.kernels.chunk_lse import (
    lse_rows, lse_rows_bwd, lse_rows_bwd_plain, lse_rows_plain)
from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
    build_chunk_plan, chunk_bwd_pass1, chunk_bwd_pass1_plain,
    chunk_bwd_pass2, chunk_bwd_pass2_plain, chunk_sddmm, chunk_sddmm_plain,
    chunk_spmm, chunk_spmm_plain, chunk_spmv, chunk_spmv_plain)
from torchsparsegradutils_tpu_torch.kernels.dia import (sddmm_core,
                                                        sddmm_core_plain,
                                                        spmm_core,
                                                        spmm_core_plain)
from torchsparsegradutils_tpu_torch.kernels.dia_tri import (
    tri_dia_core, tri_dia_core_plain)
from torchsparsegradutils_tpu_torch.kernels.window_gather import (
    window_gather, window_gather_plain)
from torchsparsegradutils_tpu_torch.types import StaticArray
from torchsparsegradutils_tpu_torch.utils.random_sparse import (
    hybrid_sparse, rand_sparse, rand_sparse_tri, stencil_sparse)

pytestmark = pytest.mark.cuda

# (rtol, atol as a fraction of max|ref|): sums run in another order
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-5),
       torch.float64: (1e-12, 1e-12)}
DTYPES = list(TOL)
# (n, m, p, offsets, lead): ``lead`` > 0 passes B as a contiguous view
# that many elements into its storage, so its data pointer is not 16-byte
# aligned and K1 takes its scalar tiles
SHAPES = [(1000, 1000, 1, [-3, 0, 3], 0),
          (777, 1200, 33, [-500, -1, 0, 7, 900], 0),
          (1300, 600, 130, [-1000, -5, 0, 2, 599], 0),
          (2000, 2000, 5, list(range(-128, 128)), 0),     # K = 256
          # windows crossing the 128- and 256-row tile edges, n % 128 != 0
          (1000, 1000, 128, [-130, -129, -2, 0, 1, 127, 129], 0),
          (1000, 900, 16, [-300, -257, -255, 0, 255, 257], 0),
          (900, 1100, 130, [-64, -3, -2, -1, 0, 1, 2, 3, 64], 0),
          (640, 700, 64, [-40, -1, 0, 1, 40], 1),           # unaligned B
          (500, 500, 8, [-3000, -1, 0, 1, 2900], 0)]        # windows of holes


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
    X = torch.randn(n, p, generator=g).to(dev, dtype)
    before = spmm_core.launches, sddmm_core.launches
    close(spmm_core(offs, grid, B), spmm_core_plain(offs, grid, B), dtype)
    close(sddmm_core(offs, X, B), sddmm_core_plain(offs, X, B), dtype)
    torch.cuda.synchronize()
    assert (spmm_core.launches, sddmm_core.launches) == (before[0] + 1,
                                                         before[1] + 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dia_spmm_repeats_bitwise_at_the_cfd2_stencil(dev, dtype):
    # bench.py's 25-offset stencil at N = 123,440, p = 128: three windows
    offsets = sorted({0, 1, -1, 2, -2, 3, -3, 49, -49, 50, -50, 51, -51,
                      2401, -2401, 2449, -2449, 2450, -2450, 2451, -2451,
                      2499, -2499, 2500, -2500})
    n = 123_440
    geo = dia.DiaGeometry(np.array(offsets), n, n)
    g = torch.Generator().manual_seed(7)
    grid = torch.randn(n, len(offsets), generator=g).to(dev, dtype)
    B = torch.randn(n, 128, generator=g).to(dev, dtype)
    offs = geo.offsets_on(dev)
    got = spmm_core(offs, grid, B, geo)
    assert torch.equal(got, spmm_core(offs, grid, B, geo))
    assert torch.equal(got, spmm_core(offs, grid, B))   # table from offs
    close(got, spmm_core_plain(offs, grid, B), dtype)


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


def _awkward_chunk_plan():
    """(n, m) = (700, 6000): every seventh row empty, row 5 dense with
    5,000 entries (longer than any block), the rest uniform random."""
    n, m = 700, 6000
    rng = np.random.default_rng(3)
    keys = np.sort(rng.choice(n * m, 20_000, replace=False))
    rows, cols = keys // m, keys % m
    keep = (rows % 7 != 0) & (rows != 5)
    rows = np.concatenate([rows[keep], np.full(5000, 5)])
    cols = np.concatenate([cols[keep], np.sort(rng.choice(m, 5000, False))])
    order = np.lexsort((cols, rows))
    return build_chunk_plan(StaticArray(rows[order]),
                            StaticArray(cols[order]), n, m)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [1, 3, 8, 128, 130, 260])
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


def test_chunk_kernels_take_unaligned_rows(dev):
    # p % 4 == 0 but a base 4 bytes off 16-byte alignment: the scalar path
    plan = _awkward_chunk_plan()
    d = plan.maps(dev)
    vals = torch.randn(plan.nnz, device=dev)
    B = torch.randn(plan.m * 64 + 1, device=dev)[1:].view(plan.m, 64)
    X = torch.randn(plan.n * 64 + 1, device=dev)[1:].view(plan.n, 64)
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,p,offsets,unit", [
    (300, 1, [-130, -17, -3, 0], False),     # n not a multiple of 256, p = 1
    (500, 3, [-256, -1, 0, 5], False),       # span at a block boundary
    (777, 5, [-300, -2, -1, 7], True),       # unit; p not a multiple of 4
    (2000, 130, [-2500 + 2000 - 1, -51, -50, -1, 0, 1, 51], False),
    (1000, 2, list(range(-200, 1)), False)])  # 200 offsets: generic loops
def test_tri_dia_kernel_matches_plain_and_repeats_bitwise(dev, dtype, n, p,
                                                          offsets, unit):
    g = torch.Generator().manual_seed(n + p)
    grid = torch.randn(n, len(offsets), generator=g) * 0.1
    if 0 in offsets:        # diagonally dominant: the solve stays bounded
        k0 = offsets.index(0)
        grid[:, k0] = 1 + grid.abs().sum(1) - grid[:, k0].abs()
    grid = grid.to(dev, dtype)
    B = torch.randn(n, p, generator=g).to(dev, dtype)
    offs = np.array(offsets)
    before = tri_dia_core.launches
    got = tri_dia_core(offs, grid, B, unit=unit)
    again = tri_dia_core(offs, grid, B, unit=unit)
    torch.cuda.synchronize()
    assert tri_dia_core.launches == before + 2
    assert torch.equal(got, again)
    close(got, tri_dia_core_plain(offs, grid, B, unit=unit), dtype)


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


def _lse_pattern():
    """(3000, 200_000): empty rows, a single entry, rows of 1,024 and
    1,025 entries (either side of the kernels' whole-block threshold),
    one row of 100,000, the rest uniform; values with +inf, -inf and an
    all -inf row."""
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("include_zeros", [False, True])
def test_lse_kernels_match_plain_and_repeat_bitwise(dev, dtype,
                                                    include_zeros):
    plan, vals = _lse_pattern()
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
@pytest.mark.parametrize("p", [3, 8, 128, 130])
def test_fused_bwd_kernels_match_plain_and_repeat_bitwise(dev, dtype, p):
    plan = _awkward_chunk_plan()
    gen = torch.Generator().manual_seed(p)
    vals = torch.randn(plan.nnz, generator=gen).to(dev, dtype)
    B = torch.randn(plan.m, p, generator=gen).to(dev, dtype)
    G = torch.randn(plan.n, p, generator=gen).to(dev, dtype)
    d, dt = plan.maps(dev), plan.T.maps(dev)
    for v_dtype in {dtype, torch.bfloat16}:
        args = (d["indptr"], d["cols"], vals, B, G, v_dtype)
        before = chunk_bwd_pass1.launches, chunk_bwd_pass2.launches
        (dd, V), (dd2, V2) = chunk_bwd_pass1(*args), chunk_bwd_pass1(*args)
        pdd, pV = chunk_bwd_pass1_plain(*args)
        dB, dB2 = (chunk_bwd_pass2(dt["indptr"], dt["perm"], V, dtype)
                   for _ in range(2))
        torch.cuda.synchronize()
        assert (chunk_bwd_pass1.launches, chunk_bwd_pass2.launches) == (
            before[0] + 2, before[1] + 2)
        assert torch.equal(dd, dd2) and torch.equal(V, V2)
        assert torch.equal(dB, dB2)
        assert V.dtype == v_dtype and dB.dtype == dtype
        # dd is K7's arithmetic; V one rounded product
        assert torch.equal(dd, chunk_sddmm(d["indptr"], d["cols"], G, B))
        close(dd, pdd, dtype)
        assert torch.equal(V, pV)
        close(dB, chunk_bwd_pass2_plain(dt["indptr"], dt["perm"], V, dtype),
              dtype)


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
    before = chunk_bwd_pass1.launches, chunk_bwd_pass2.launches
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
    assert chunk_bwd_pass1.launches == before[0] + 2
    assert chunk_bwd_pass2.launches == before[1] + 2


def test_lse_and_fused_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ip = torch.tensor([0, 1, 2], device=dev)
    v = torch.ones(2, device=dev)
    with pytest.raises(ValueError, match="per-row tensors"):
        lse_rows_bwd(ip, v, torch.ones(2, device=dev, dtype=torch.float64),
                     torch.ones(2, device=dev))
    with pytest.raises(ValueError, match="float32, bfloat16 or float64"):
        lse_rows(ip, v.half(), 3, True)
    x = torch.ones(2, 4, device=dev)
    with pytest.raises(ValueError, match="B's dtype or bfloat16"):
        chunk_bwd_pass1(ip, ip[:2], v, x, x, torch.float64)
    with pytest.raises(ValueError, match="bad operand shapes"):
        chunk_bwd_pass1(ip, ip[:2], v, x, x[:1], torch.float32)
    with pytest.raises(ValueError, match="takes V in"):
        chunk_bwd_pass2(ip, ip[:2], x.double(), torch.float32)


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
                     lambda: chunk_bwd_pass2(offs.repeat(2), offs, x[:1],
                                             torch.float32)):
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
