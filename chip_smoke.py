#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root with one CUDA card visible:

    python3 chip_smoke.py

It imports only ``torch``, numpy and ``torchsparsegradutils_tpu_torch``
(nothing of JAX), and runs five phases; any failure raises and the
script exits non-zero without its last line:

1. prints the card's name and power limit (``nvidia-smi``), builds the
   CUDA kernels of ``torchsparsegradutils_tpu_torch/csrc`` (one ``nvcc``
   each, all at once) and prints the build time;
2. holds each kernel against its plain PyTorch version on the card in
   float32, bfloat16 and float64: the DIA kernels and the gather at the
   cfd2 shapes (N = 123,440 rows, the 25-offset stencil of ``bench.py``,
   p = 128); the chunk kernels on a uniform random pattern of cfd2 size
   (3,087,898 entries; SpMM and SDDMM at p = 128, SpMV at p = 1, the
   SpMM over the transpose plan too), each run twice and bitwise equal,
   and at a small size with empty rows, a row of 5,000 entries, p = 3
   and n != m;
3. runs ``sparse_mm`` forward and backward through the public entry
   point on that stencil, on a hybrid pattern at 85 % DIA coverage, at
   p = 16, and on the random pattern at p = 128 and p = 1, and public
   ``sddmm`` on the random pattern; checks outputs and gradients against
   the generic ``backend="xla"`` path on the card and a small case
   against a dense product, and checks that each kernel of each path
   launched during its run (counters set to 0 just before, read just
   after);
   ``sparse_triangular_solve`` forward and backward on two patterns:
   *tri-stencil*, the stencil's lower triangle (13 offsets, diagonally
   dominant) at p = 128 and p = 2, its upper mirror and its transposed
   solve, on the banded kernel; *tri-random*, a random lower factor of
   1,543,949 entries at p = 2, on the route ``auto`` picks.  It checks the
   relative residual ``|A x - B| / |B|`` through ``sparse_mm``, the
   gradients against another algorithm on the card, a small case against
   a dense solve, and the launch counters (the triangular kernel also
   against its plain version at the cfd2 shapes and small awkward ones in
   phase 2);
4. times the chained forward and forward+backward steps, profiles
   six of them, times the triangular solve's host plans, and times each
   kernel, its plain version and one PyTorch library call that computes
   the same function, with CUDA events, and prints them as a
   ``{"kernels": [...]}`` line;
5. prints ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device it exits 1 and prints no result.
"""

import json
import subprocess
import sys
import time

N = 123_440           # cfd2 rows (bench.py)
P = 128               # RHS width (bench.py)
NNZ_HYBRID = 3_087_898
NNZ_RANDOM = 3_087_898  # bench.py's uniform random regime at cfd2 scale
STENCIL_OFFSETS = sorted({0, 1, -1, 2, -2, 3, -3, 49, -49, 50, -50, 51,
                          -51, 2401, -2401, 2449, -2449, 2450, -2450,
                          2451, -2451, 2499, -2499, 2500, -2500})
TRI_OFFSETS = [o for o in STENCIL_OFFSETS if o <= 0]   # its lower triangle
NNZ_TRI_RANDOM = 1_543_949  # benchmarks/probe_tri.py:34-36, the cfd2 factor
HBM_BYTES_S = 3.35e12   # H100 SXM data sheet
F32_FLOP_S = 67e12      # H100 SXM data sheet, float32 outside tensor cores
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-5),
       "float64": (1e-12, 1e-12)}  # (rtol, atol as a fraction of max|ref|)
TRI_TOL = (1e-3, 1e-4)  # (rtol, atol): tri gradients across algorithms
DIA_KERNELS = ("dia_spmm", "dia_sddmm", "gather")
CHUNK_KERNELS = ("chunk_spmm", "chunk_sddmm", "gather")
TRI_KERNELS = ("tri_dia", "dia_sddmm", "gather")
TRI_RANDOM_KERNELS = ("chunk_sddmm", "gather")
ROUTES = []             # triangular-solve routes taken, in order


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def close(name, got, ref, dtype_name, tol=None):
    """Max |got - ref| after checking |got - ref| <= atol + rtol |ref|;
    ``tol`` gives (rtol, absolute atol) in place of ``TOL``."""
    import torch
    rtol, atol_frac = TOL[dtype_name] if tol is None else tol
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite values")
    err = (got - ref).abs()
    atol = atol_frac * (ref.abs().max().item() if tol is None else 1.0)
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name} [{dtype_name}]: {int(bad.sum())} elements off, max "
            f"abs err {err.max().item():.3e} (rtol {rtol}, atol {atol:.3e})")
    print(f"  {name} [{dtype_name}]: max abs err {err.max().item():.3e} "
          f"(rtol {rtol}, atol {atol:.3e}) ok")
    return err.max().item()


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def valid_cells(offsets, n, m):
    """Grid cells (r, k) with 0 <= r + off_k < m: the FMAs per column."""
    return sum(max(0, min(n, m - o) - max(0, -o)) for o in offsets)


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def profile_step(label, step, steps=5, top=8):
    """Device time by kernel over ``steps`` chained steps (torch.profiler),
    and the device's busy share of the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel entries only: the op that launched a kernel repeats its time
    rows = [(e.key, e.self_device_time_total / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(t for _, t in rows)
    rows.sort(key=lambda r: -r[1])
    print(json.dumps({f"profile_{label}": {
        "device_us_per_step": busy, "wall_us_per_step": wall_us / steps,
        "busy_share": busy * steps / wall_us,
        "top": [[k[:60], t] for k, t in rows[:top]]}}))


def counters():
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_sddmm, chunk_spmm, chunk_spmv)
    from torchsparsegradutils_tpu_torch.kernels.dia import (sddmm_core,
                                                            spmm_core)
    from torchsparsegradutils_tpu_torch.kernels.dia_tri import tri_dia_core
    from torchsparsegradutils_tpu_torch.kernels.window_gather import (
        window_gather)
    return {"dia_spmm": spmm_core, "dia_sddmm": sddmm_core,
            "gather": window_gather, "chunk_spmm": chunk_spmm,
            "chunk_sddmm": chunk_sddmm, "chunk_spmv": chunk_spmv,
            "tri_dia": tri_dia_core}


def track_routes():
    """Record in ``ROUTES`` each block or wave solve of the triangular
    solve (the banded route shows in the ``tri_dia`` counter)."""
    from torchsparsegradutils_tpu_torch.ops import triangular_solve as ts
    for name, label in (("_blocked_tri_solve", "block"),
                        ("_wave_tri_solve", "wave"),
                        ("tri_dia_core", "dia")):
        fn = getattr(ts, name)

        def wrapped(*a, _fn=fn, _label=label, **k):
            ROUTES.append(_label)
            return _fn(*a, **k)
        setattr(ts, name, wrapped)


def zero_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters(label, expect):
    """Launch counts since :func:`zero_counters`; raises if a kernel of
    ``expect`` did not launch."""
    import torch
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    print(f"  {label}: launches {launches}")
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} never launched")
    return launches


def fwd_bwd(A, B, G, backend):
    import torch
    from torchsparsegradutils_tpu_torch import sparse_mm
    v = A.values.detach().clone().requires_grad_(True)
    b = B.detach().clone().requires_grad_(True)
    out = sparse_mm(A.with_data(v), b, backend=backend)
    gv, gb = torch.autograd.grad(out, (v, b), G)
    return out, gv, gb


def drive(label, A, B, G, expect):
    """One fwd+bwd through the public entry with the counters set to 0
    just before and read just after (each kernel of ``expect`` must have
    launched); then the generic path as reference."""
    zero_counters()
    out, gv, gb = fwd_bwd(A, B, G, "auto")
    launches = read_counters(label, expect)
    ref = fwd_bwd(A, B, G, "xla")
    for name, got, r in zip(("out", "gradA", "gradB"), (out, gv, gb), ref):
        close(f"{label} {name} vs generic path", got, r, "float32")
    return launches


def tri_fwd_bwd(A, B, G, **kw):
    import torch
    from torchsparsegradutils_tpu_torch import sparse_triangular_solve
    v = A.values.detach().clone().requires_grad_(True)
    b = B.detach().clone().requires_grad_(True)
    x = sparse_triangular_solve(A.with_data(v), b, **kw)
    gv, gb = torch.autograd.grad(x, (v, b), G)
    return x, gv, gb


def residual(A, x, B, transpose):
    """|op(A) x - B| / |B| through the port's sparse_mm, for the
    triangle that ``upper`` selects (the whole pattern here)."""
    from torchsparsegradutils_tpu_torch import sparse_mm
    Ax = sparse_mm(A.T if transpose else A, x)
    return ((Ax - B).norm() / B.norm()).item()


def drive_tri(label, A, B, G, expect, ref_algorithm=None, **kw):
    """One fwd+bwd of the triangular solve through the public entry, the
    counters set to 0 just before and read just after; the residual
    check; with ``ref_algorithm`` the output and gradients against that
    algorithm on the card."""
    import torch
    zero_counters()
    ROUTES.clear()
    x, gv, gb = tri_fwd_bwd(A, B, G, **kw)
    launches = read_counters(label, expect)
    print(f"  {label}: routes forward {ROUTES[:1]}, backward {ROUTES[1:]}")
    res = residual(A, x, B, kw.get("transpose", False))
    print(f"  {label}: relative residual {res:.3e}")
    if not res <= 1e-5:
        raise AssertionError(f"{label}: relative residual {res:.3e} > 1e-5")
    if ref_algorithm is not None:
        ref = tri_fwd_bwd(A, B, G, **dict(kw, algorithm=ref_algorithm))
        for name, got, r in zip(("x", "gradA", "gradB"), (x, gv, gb), ref):
            close(f"{label} {name} vs algorithm={ref_algorithm}", got, r,
                  "float32", TRI_TOL)
    torch.cuda.synchronize()
    return launches, list(ROUTES)


def sddmm_fwd_bwd(A, X, Y, C, backend):
    import torch
    from torchsparsegradutils_tpu_torch import sddmm
    x = X.detach().clone().requires_grad_(True)
    y = Y.detach().clone().requires_grad_(True)
    vals = sddmm(A, x, y, backend=backend).values
    return (vals, *torch.autograd.grad(vals, (x, y), C))


def awkward_pattern():
    """(700, 6000): every seventh row empty, row 5 holding 5,000 entries
    (longer than any block), the rest uniform random."""
    import numpy as np
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        build_chunk_plan)
    from torchsparsegradutils_tpu_torch.types import StaticArray
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


def check_chunk_kernels(label, plan, vals, B, X, dt_name):
    """K6 (A@B and Aᵀ X), K7 and K8 against their plain versions, each
    launched twice and bitwise equal; returns the largest errors."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_sddmm, chunk_sddmm_plain, chunk_spmm, chunk_spmm_plain,
        chunk_spmv, chunk_spmv_plain)
    d, dt = plan.maps(B.device), plan.T.maps(B.device)
    vals_t = plan.to_T(vals)
    x = B[:, 0].contiguous()
    checks = [
        ("chunk_spmm", "A@B", chunk_spmm, chunk_spmm_plain,
         (d["indptr"], d["cols"], vals, B)),
        ("chunk_spmm", "A^T X", chunk_spmm, chunk_spmm_plain,
         (dt["indptr"], dt["cols"], vals_t, X)),
        ("chunk_sddmm", "X, B", chunk_sddmm, chunk_sddmm_plain,
         (d["indptr"], d["cols"], X, B)),
        ("chunk_spmv", "A@x", chunk_spmv, chunk_spmv_plain,
         (d["indptr"], d["cols"], vals, x))]
    err = {}
    for name, what, kern, plain, args in checks:
        got, again = kern(*args), kern(*args)
        if not torch.equal(got, again):
            raise AssertionError(f"{label} {name} {what} [{dt_name}]: two "
                                 "launches differ")
        e = close(f"{label} {name} {what} (repeats bitwise)", got,
                  plain(*args), dt_name)
        err[name] = max(err.get(name, 0.0), e)
    return err


def check_tri_small(dt, name, gen, dev):
    """The triangular kernel on small awkward shapes: n not a multiple of
    the block, p = 1 and 3, unit, positive offsets (ignored), the span at a
    block boundary, and 200 offsets (the generic loops)."""
    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch.kernels.dia_tri import (
        tri_dia_core, tri_dia_core_plain)
    for n, p, offs, unit in ((300, 1, [-130, -17, -3, 0], False),
                             (500, 3, [-256, -1, 0, 5], False),
                             (777, 5, [-300, -2, -1, 7], True),
                             (1000, 2, list(range(-200, 1)), False)):
        g = torch.randn(n, len(offs), generator=gen) * 0.1
        if 0 in offs:
            k0 = offs.index(0)
            g[:, k0] = 1 + g.abs().sum(1) - g[:, k0].abs()
        g = g.to(dev, dt)
        b = torch.randn(n, p, generator=gen).to(dev, dt)
        close(f"tri_dia small n={n} p={p} K={len(offs)} unit={unit}",
              tri_dia_core(np.array(offs), g, b, unit=unit),
              tri_dia_core_plain(np.array(offs), g, b, unit=unit), name)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from torchsparsegradutils_tpu_torch import sparse_mm
    from torchsparsegradutils_tpu_torch.kernels import _build
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        build_chunk_plan, chunk_sddmm, chunk_sddmm_plain, chunk_spmm,
        chunk_spmm_plain, chunk_spmv, chunk_spmv_plain)
    from torchsparsegradutils_tpu_torch.kernels.dia import (
        build_dia_plan, sddmm_core, sddmm_core_plain, spmm_core,
        spmm_core_plain, values_to_grid)
    from torchsparsegradutils_tpu_torch.kernels.dia_tri import (
        tri_dia_core, tri_dia_core_plain)
    from torchsparsegradutils_tpu_torch.kernels.window_gather import (
        window_gather, window_gather_plain)
    from torchsparsegradutils_tpu_torch.ops import triangular_solve as ts
    from torchsparsegradutils_tpu_torch.utils.random_sparse import (
        hybrid_sparse, rand_sparse, rand_sparse_tri, stencil_sparse)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # ---- phase 1: build -------------------------------------------------
    info = _build.build()
    _build.libraries()
    print(f"phase 1: kernels built in {info['seconds']:.1f} s "
          f"({info['dir']})")
    t0 = time.perf_counter()
    for name, log in info["logs"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- phase 2: each kernel against its plain version -------------------
    print("phase 2: kernels vs plain versions at the cfd2 shapes")
    gen = torch.Generator().manual_seed(0)
    A = stencil_sparse((N, N), STENCIL_OFFSETS, generator=gen, device=dev)
    plan = build_dia_plan(A.row_sa(), A.col_sa(), N, N)
    maps = plan.maps(dev)
    offs = plan.geo.offsets_on(dev)
    offs_t = plan.geo.T.offsets_on(dev)
    B = torch.randn(N, P, generator=gen).to(dev)
    G = torch.randn(N, P, generator=gen).to(dev)
    grid = values_to_grid(plan, A.values)
    R = rand_sparse((N, N), NNZ_RANDOM, layout="csr", generator=gen,
                    device=dev)
    cplan = build_chunk_plan(R.row_sa(), R.col_sa(), N, N)
    small = awkward_pattern()
    T = stencil_sparse((N, N), TRI_OFFSETS, well_conditioned=True,
                       generator=gen, device=dev)
    tplan = build_dia_plan(T.row_sa(), T.col_sa(), N, N)
    tgrid = values_to_grid(tplan, T.values)
    TB = torch.randn(N, P, generator=gen).to(dev)
    err = {}
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        name = str(dt).removeprefix("torch.")
        g, b, gg = grid.to(dt), B.to(dt), G.to(dt)
        gt = plan.geo.shift(g)
        e1 = close("dia_spmm A@B", spmm_core(offs, g, b),
                   spmm_core_plain(offs, g, b), name)
        e2 = close("dia_spmm A^T G", spmm_core(offs_t, gt, gg),
                   spmm_core_plain(offs_t, gt, gg), name)
        e3 = close("dia_sddmm", sddmm_core(offs, gg, b),
                   sddmm_core_plain(offs, gg, b), name)
        vals = A.values.to(dt)
        for what, src, idx in (("values->grid", vals, maps["src_of_grid"]),
                               ("grid->values", g.reshape(-1), maps["pos"])):
            got = window_gather(src, idx)
            if not torch.equal(got, window_gather_plain(src, idx)):
                raise AssertionError(f"gather {what} [{name}] not exact")
            print(f"  gather {what} [{name}]: exact")
        ec = check_chunk_kernels("random cfd2", cplan, R.values.to(dt), b, gg,
                                 name)
        sv = torch.randn(small.nnz, generator=gen).to(dev, dt)
        sB = torch.randn(small.m, 3, generator=gen).to(dev, dt)
        sX = torch.randn(small.n, 3, generator=gen).to(dev, dt)
        check_chunk_kernels("small p=3", small, sv, sB, sX, name)
        d = small.maps(dev)
        if not bool((chunk_spmm(d["indptr"], d["cols"], sv, sB)[::7] == 0
                     ).all()):
            raise AssertionError("chunk_spmm: an empty row is not 0")
        if dt == torch.float32:
            err = {"dia_spmm": max(e1, e2), "dia_sddmm": e3, "gather": 0.0,
                   **ec}
        # the triangular kernel on the stencil's lower triangle
        tg = tgrid.to(dt)
        for tb in (TB.to(dt), TB[:, :2].contiguous().to(dt)):
            got = tri_dia_core(tplan.offsets, tg, tb, unit=False)
            again = tri_dia_core(tplan.offsets, tg, tb, unit=False)
            if not torch.equal(got, again):
                raise AssertionError(f"tri_dia p={tb.shape[1]} [{name}]: "
                                     "two launches differ")
            e = close(f"tri_dia p={tb.shape[1]} (repeats bitwise)", got,
                      tri_dia_core_plain(tplan.offsets, tg, tb, unit=False),
                      name)
            if dt == torch.float32:
                err["tri_dia"] = max(err.get("tri_dia", 0.0), e)
        check_tri_small(dt, name, gen, dev)

    # ---- phase 3: the main path --------------------------------------------
    print(f"phase 3: sparse_mm fwd+bwd through the public entry point "
          f"({time.perf_counter() - t0:.1f} s in)")
    small_st = stencil_sparse((512, 512), [-40, -3, 0, 2, 40],
                              generator=gen, device=dev)
    Bs = torch.randn(512, 8, generator=gen).to(dev)
    close("small stencil vs dense f64", sparse_mm(small_st, Bs),
          small_st.todense().double() @ Bs.double(), "float32")
    small_r = rand_sparse((500, 400), 6000, layout="csr", generator=gen,
                          device=dev)
    close("small random vs dense f64", sparse_mm(small_r, Bs[:400]),
          small_r.todense().double() @ Bs[:400].double(), "float32")
    launches = drive("stencil p=128", A, B, G, DIA_KERNELS)
    H = hybrid_sparse((N, N), STENCIL_OFFSETS, NNZ_HYBRID, dia_coverage=0.85,
                      generator=gen, device=dev)
    drive("hybrid85 p=128", H, B, G,
          DIA_KERNELS + ("chunk_spmm", "chunk_sddmm"))
    B16, G16 = B[:, :16].contiguous(), G[:, :16].contiguous()
    drive("stencil p=16", A, B16, G16, DIA_KERNELS)
    launches_r = drive("random p=128", R, B, G, CHUNK_KERNELS)
    B1, G1 = B[:, :1].contiguous(), G[:, :1].contiguous()
    launches_r1 = drive("random p=1", R, B1, G1,
                        ("chunk_spmv", "chunk_sddmm", "gather"))
    C = torch.randn(R.nnz, generator=gen).to(dev)
    zero_counters()
    got = sddmm_fwd_bwd(R, G, B, C, "auto")
    read_counters("random sddmm p=128", CHUNK_KERNELS)
    for name, g_, r_ in zip(("values", "gradX", "gradY"), got,
                            sddmm_fwd_bwd(R, G, B, C, "xla")):
        close(f"random sddmm {name} vs generic path", g_, r_, "float32")

    print(f"phase 3b: sparse_triangular_solve fwd+bwd "
          f"({time.perf_counter() - t0:.1f} s in)")
    from torchsparsegradutils_tpu_torch import sparse_triangular_solve
    track_routes()
    for lower_offs, upper in ((TRI_OFFSETS[-5:], False),
                              ([-o for o in TRI_OFFSETS[-5:]], True)):
        St = stencil_sparse((2000, 2000), lower_offs, well_conditioned=True,
                            generator=gen, device=dev)
        Rt = rand_sparse_tri((2000, 2000), 25_000, upper=upper,
                             layout="csr", generator=gen, device=dev)
        bs = torch.randn(2000, 3, generator=gen).to(dev)
        for what, M in (("stencil", St), ("random", Rt)):
            for tr in (False, True):
                Md = M.todense().double()
                close(f"small tri-{what} upper={upper} transpose={tr} vs "
                      "dense f64", sparse_triangular_solve(
                          M, bs, upper=upper, transpose=tr),
                      torch.linalg.solve_triangular(
                          Md.T if tr else Md, bs.double(),
                          upper=upper != tr), "float32")
    GT = torch.randn(N, P, generator=gen).to(dev)
    TB2, GT2 = TB[:, :2].contiguous(), GT[:, :2].contiguous()
    launches_t, _ = drive_tri("tri-stencil p=128", T, TB, GT, TRI_KERNELS,
                              ref_algorithm="block", upper=False)
    drive_tri("tri-stencil p=2", T, TB2, GT2, TRI_KERNELS,
              ref_algorithm="block", upper=False)
    Tu = stencil_sparse((N, N), [-o for o in TRI_OFFSETS],
                        well_conditioned=True, generator=gen, device=dev)
    drive_tri("tri-stencil upper mirror p=128", Tu, TB, GT, TRI_KERNELS,
              upper=True)
    drive_tri("tri-stencil transpose p=128", T, TB, GT, TRI_KERNELS,
              upper=False, transpose=True)
    TR = rand_sparse_tri((N, N), NNZ_TRI_RANDOM, upper=False, layout="csr",
                         generator=gen, device=dev)
    t_first = time.perf_counter()
    launches_tr, routes_tr = drive_tri("tri-random p=2", TR, TB2, GT2,
                                       TRI_RANDOM_KERNELS, upper=False)
    t_first = time.perf_counter() - t_first
    other = "wave" if routes_tr[0] == "block" else "block"
    drive_tri("tri-random p=2 (again)", TR, TB2, GT2, TRI_RANDOM_KERNELS,
              ref_algorithm=other, upper=False)

    # ---- phase 4: timing ---------------------------------------------------
    print(f"phase 4: timing ({time.perf_counter() - t0:.1f} s in)")
    eps = 1e-6

    def chain_fwd(A, B):
        state = {"b": B.clone()}

        def step():
            with torch.no_grad():
                state["b"] = state["b"] + eps * sparse_mm(A, state["b"])
        return step

    def chain_step(A, B, G):
        state = {"v": A.values.detach().clone(), "b": B.clone()}

        def step():
            v = state["v"].requires_grad_(True)
            b = state["b"].requires_grad_(True)
            out = sparse_mm(A.with_data(v), b)
            gv, gb = torch.autograd.grad(out, (v, b), G)
            state["v"] = (v + eps * gv).detach()
            state["b"] = (b + eps * gb).detach()
        return step

    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    steps = {
        "stencil_fwd_ms": time_ms(chain_fwd(A, B), reps=50),
        "stencil_fwd_bwd_ms": time_ms(chain_step(A, B, G), reps=50),
        "stencil_fwd_bwd_peak_extra_mib":
            torch.cuda.max_memory_allocated() / 2**20 - base_mib,
        "hybrid85_fwd_bwd_ms": time_ms(chain_step(H, B, G), reps=50),
        "stencil_p16_fwd_bwd_ms": time_ms(chain_step(A, B16, G16), reps=20),
        "random_fwd_ms": time_ms(chain_fwd(R, B), reps=50),
        "random_fwd_bwd_ms": time_ms(chain_step(R, B, G), reps=50),
        "random_p1_fwd_bwd_ms": time_ms(chain_step(R, B1, G1), reps=50),
    }

    def chain_tri(A, B, G, **kw):
        state = {"v": A.values.detach().clone(), "b": B.clone()}

        def step():
            v = state["v"].requires_grad_(True)
            b = state["b"].requires_grad_(True)
            x = sparse_triangular_solve(A.with_data(v), b, **kw)
            gv, gb = torch.autograd.grad(x, (v, b), G)
            state["v"] = (v + eps * gv).detach()
            state["b"] = (b + eps * gb).detach()
        return step

    def chain_tri_fwd(A, B, **kw):
        state = {"b": B.clone()}

        def step():
            with torch.no_grad():
                state["b"] = state["b"] + eps * sparse_triangular_solve(
                    A, state["b"], **kw)
        return step

    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    steps.update({
        "tri_stencil_fwd_ms": time_ms(chain_tri_fwd(T, TB, upper=False),
                                      reps=10),
        "tri_stencil_fwd_bwd_ms": time_ms(chain_tri(T, TB, GT, upper=False),
                                          reps=10),
        "tri_stencil_p2_fwd_ms": time_ms(chain_tri_fwd(T, TB2, upper=False),
                                         reps=10),
        "tri_stencil_p2_fwd_bwd_ms": time_ms(
            chain_tri(T, TB2, GT2, upper=False), reps=10),
        "tri_stencil_fwd_bwd_peak_extra_mib":
            torch.cuda.max_memory_allocated() / 2**20 - base_mib,
    })
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    steps.update({
        "tri_random_fwd_ms": time_ms(chain_tri_fwd(TR, TB2, upper=False),
                                     reps=5, warmup=1),
        "tri_random_fwd_bwd_ms": time_ms(
            chain_tri(TR, TB2, GT2, upper=False), reps=5, warmup=1),
        "tri_random_fwd_bwd_peak_extra_mib":
            torch.cuda.max_memory_allocated() / 2**20 - base_mib,
        "tri_random_routes": routes_tr,
        "tri_random_first_fwd_bwd_s": t_first,
    })
    # host time of the triangular solve's plans at cfd2 scale (numpy)
    rs, cs = TR.row_sa(), TR.col_sa()
    host = {}
    t1 = time.perf_counter()
    ts.tri_levels(rs.arr, cs.arr, N)
    host["tri_levels_s"] = time.perf_counter() - t1
    for name, build in (("block_plan_s", lambda: ts._build_tri_plan.__wrapped__(
                            rs, cs, N, 512, True)),
                        ("wave_plan_s", lambda: ts._build_wave_plan.__wrapped__(
                            rs, cs, N, 128, True)),
                        ("block_plan_transpose_s",
                         lambda: ts._build_tri_plan.__wrapped__(
                             cs, rs, N, 512, False)),
                        ("wave_plan_transpose_s",
                         lambda: ts._build_wave_plan.__wrapped__(
                             cs, rs, N, 128, False))):
        t1 = time.perf_counter()
        build()
        host[name] = time.perf_counter() - t1
    print(json.dumps({"main_path": steps, "tri_random_host": host,
                      "card": card}))
    profile_step("tri_stencil_fwd_bwd_step", chain_tri(T, TB, GT,
                                                       upper=False), steps=3)
    profile_step("tri_random_fwd_bwd_step", chain_tri(TR, TB2, GT2,
                                                      upper=False), steps=3)
    profile_step("stencil_fwd_bwd_step", chain_step(A, B, G))
    profile_step("hybrid85_fwd_bwd_step", chain_step(H, B, G))
    profile_step("random_fwd_bwd_step", chain_step(R, B, G))
    profile_step("random_p1_fwd_bwd_step", chain_step(R, B1, G1))

    es = 4
    n, m, K = N, N, plan.K
    cells = valid_cells(plan.offsets.tolist(), n, m)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr_np().astype("int64")).to(dev),
        A.cols_t(), A.values, (n, m))
    offs_list = plan.offsets.tolist()
    vals_pad = torch.cat([A.values, A.values.new_zeros(1)])
    idx_pad = torch.where(maps["src_of_grid"] >= 0, maps["src_of_grid"],
                          A.nnz)
    cm = cplan.maps(dev)
    csr_r = torch.sparse_csr_tensor(cm["indptr"], cm["cols"], R.values,
                                    (n, m))
    x1 = B1.view(-1)
    nnz_r = R.nnz
    ucols = len(np.unique(R.cols()))               # B rows the pattern reads
    urows = int((cplan.indptr[1:] > cplan.indptr[:-1]).sum())
    idx_bytes = nnz_r * 8 + (n + 1) * 8            # cols + indptr, int64
    rows = []
    spec = [
        ("dia_spmm", "torchsparsegradutils_tpu_torch/csrc/dia_spmm.cu",
         "torchsparsegradutils_tpu/kernels/dia_mxu.py:838 (K1 "
         "spmm_core_mxu) and torchsparsegradutils_tpu/kernels/dia.py:477 "
         "(K4 _spmm_core_pallas)", launches,
         lambda: spmm_core(offs, grid, B),
         lambda: spmm_core_plain(offs_list, grid, B),
         lambda: torch.sparse.mm(csr, B),
         bound((n * K + m * P + n * P) * es + K * 8, 2 * cells * P)),
        ("dia_sddmm", "torchsparsegradutils_tpu_torch/csrc/dia_sddmm.cu",
         "torchsparsegradutils_tpu/kernels/dia_mxu.py:974 (K2 "
         "sddmm_core_mxu) and torchsparsegradutils_tpu/kernels/dia.py:538 "
         "(K5 _dia_sddmm_pallas)", launches,
         lambda: sddmm_core(offs, G, B),
         lambda: sddmm_core_plain(offs_list, G, B),
         lambda: torch.sparse.sampled_addmm(csr, G, B.t(), beta=0.0),
         bound((n * P + m * P + n * K) * es + K * 8, 2 * cells * P)),
        ("gather", "torchsparsegradutils_tpu_torch/csrc/gather.cu",
         "torchsparsegradutils_tpu/kernels/window_gather.py:402 (K3 "
         "_window_gather_impl)", launches,
         lambda: window_gather(A.values, maps["src_of_grid"]),
         lambda: window_gather_plain(A.values, maps["src_of_grid"]),
         lambda: torch.index_select(vals_pad, 0, idx_pad),
         bound(n * K * 8 + A.nnz * es + n * K * es, 0)),
        ("chunk_spmm", "torchsparsegradutils_tpu_torch/csrc/chunk_spmm.cu",
         "torchsparsegradutils_tpu/kernels/chunk_spmm.py:248 (K6 "
         "chunk_spmm)", launches_r,
         lambda: chunk_spmm(cm["indptr"], cm["cols"], R.values, B),
         lambda: chunk_spmm_plain(cm["indptr"], cm["cols"], R.values, B),
         lambda: torch.sparse.mm(csr_r, B),
         bound(nnz_r * es + idx_bytes + (ucols + n) * P * es,
               2 * nnz_r * P)),
        ("chunk_sddmm", "torchsparsegradutils_tpu_torch/csrc/chunk_sddmm.cu",
         "torchsparsegradutils_tpu/kernels/chunk_spmm.py:349 (K7 "
         "chunk_sddmm)", launches_r,
         lambda: chunk_sddmm(cm["indptr"], cm["cols"], G, B),
         lambda: chunk_sddmm_plain(cm["indptr"], cm["cols"], G, B),
         lambda: torch.sparse.sampled_addmm(csr_r, G, B.t(), beta=0.0),
         bound((urows + ucols) * P * es + idx_bytes + nnz_r * es,
               2 * nnz_r * P)),
        ("chunk_spmv", "torchsparsegradutils_tpu_torch/csrc/chunk_spmv.cu",
         "torchsparsegradutils_tpu/kernels/chunk_spmm.py:296 (K8 "
         "chunk_spmv)", launches_r1,
         lambda: chunk_spmv(cm["indptr"], cm["cols"], R.values, x1),
         lambda: chunk_spmv_plain(cm["indptr"], cm["cols"], R.values, x1),
         lambda: torch.sparse.mm(csr_r, B1),
         bound(nnz_r * es + idx_bytes + (ucols + n) * es, 2 * nnz_r)),
    ]
    Kt = tplan.K
    tcells = valid_cells(tplan.offsets.tolist(), n, n)
    tcsr = torch.sparse_csr_tensor(
        torch.from_numpy(T.indptr_np().astype("int64")).to(dev),
        T.cols_t(), T.values, (n, n))
    spec.append(
        ("tri_dia", "torchsparsegradutils_tpu_torch/csrc/tri_dia.cu",
         "torchsparsegradutils_tpu/kernels/dia_tri.py:150 (K9 "
         "tri_dia_core)", launches_t,
         lambda: tri_dia_core(tplan.offsets, tgrid, TB, unit=False),
         lambda: tri_dia_core_plain(tplan.offsets, tgrid, TB, unit=False),
         lambda: torch.triangular_solve(TB, tcsr, upper=False),
         bound((n * Kt + 2 * n * P) * es, 2 * tcells * P)))
    for name, source, replaces, lc, kern, plain, lib, (b_ms, b_by) in spec:
        reps = 5 if name == "tri_dia" else 20
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": lc[name],
            "max_abs_err": err[name], "ms": time_ms(kern, reps=reps),
            "plain_ms": time_ms(plain, reps=reps), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}
        try:
            row["library_ms"] = time_ms(lib, reps=reps)
        except (RuntimeError, NotImplementedError) as exc:
            row["library_error"] = str(exc).splitlines()[0][:200]
        rows.append(row)
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
