#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root with one CUDA card visible:

    python3 chip_smoke.py

It imports only ``torch`` (``torch.distributed`` too), numpy and
``torchsparsegradutils_tpu_torch`` (nothing of JAX), and runs five
phases; any failure raises and the script exits non-zero without its
last line:

1. prints the card's name and power limit (``nvidia-smi``), builds the
   CUDA kernels of ``torchsparsegradutils_tpu_torch/csrc`` (one ``nvcc``
   each, all at once) and prints the build time;
2. holds each kernel against its plain PyTorch version on the card in
   float32, bfloat16 and float64: the DIA kernels and the gather at the
   cfd2 shapes (N = 123,440 rows, the 25-offset stencil of ``bench.py``,
   p = 128); K1 (the DIA SpMM) also for A @ B and Aᵀ G at p = 128, 16
   and 1, each launch twice and bitwise equal, and on an awkward set
   (isolated offsets, a run of 256, n != m both ways, p = 3 and 130,
   offsets beyond +-m, an unaligned B, the sharded-dia window), after
   printing its window tables for the stencil and its transpose
   (``k1_windows``); the chunk kernels on a uniform random pattern of
   cfd2 size (3,087,898 entries; SpMM and SDDMM at p = 128, SpMV at
   p = 1, the SpMM over the transpose plan too), each run twice and
   bitwise equal, and at a small size with empty rows, a row of 5,000
   entries, p = 3 and n != m;
3. runs ``sparse_mm`` forward and backward through the public entry
   point on that stencil, on a hybrid pattern at 85 % DIA coverage, at
   p = 16, and on the random pattern at p = 128 and p = 1, and public
   ``sddmm`` on the random pattern; checks outputs and gradients against
   the generic ``backend="xla"`` path on the card and a small case
   against a dense product, and checks that each kernel of each path
   launched during its run (counters set to 0 just before, read just
   after; K1's plain version must not run either);
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
   ``sparse_logsumexp`` (dim 1, dim 0) and ``sparse_bidir_logsumexp``
   forward and backward on three patterns: *lse-stencil* (the DIA route),
   *lse-random* (the row-ELL grid both ways) and *lse-skewed* (1,235 hub
   rows of 1,250 entries and uniform rest, 3,087,898 entries: the chunk
   LSE kernels on rows, the ELL grid on columns), against the segment
   path on the card, with per-route launch checks (the chunk LSE kernels
   launch on lse-skewed only); and *random-fused*, ``sparse_mm`` on the
   random pattern at p = 128 with ``SPMM_BWD = "fused"`` (and
   ``grad_precision="fast"``), against the split backward (the LSE and
   fused kernels also against their plain versions at the cfd2 shapes
   and small awkward ones in phase 2);
   then (3d) ``parallel/`` on a one-rank NCCL group (a ``FileStore`` in
   a temporary directory, destroyed at the end): K13, the row-slab SpMM,
   against its plain version on each slab of a 4-shard plan of the
   random pattern and on the whole matrix (three dtypes, bitwise
   repeats, each slab's rows bitwise K6's) and on the small awkward and
   uneven patterns at p = 3; ``sharded_chunk_spmm`` (K13 must launch,
   its plain version must not) and ``sharded_sparse_mm`` on the random
   pattern and ``sharded_dia_spmm`` on the stencil, forward and backward
   through their entry points at world size 1 and as the 4-shard
   layout's per-rank bodies, against the unsharded ``sparse_mm``; the
   flagship train step at full width (``make_model((1, 48, 48, 48),
   radius=1.5)``: 110,592 voxels, 961,056 entries, 128 observations,
   five SGD steps at lr 1e-2; the loss must fall and step 1 match the
   unsharded ``loss_fn`` step); K13's time per slab beside its bound,
   plain version and ``torch.sparse.mm``, the sharded steps beside the
   unsharded ones, and the train step with a profile;
4. times the chained forward and forward+backward steps, profiles
   seven of them, times the triangular solve's host plans, times K1 per
   launch at p = 128, 16 and 1 and for Aᵀ G (``k1_times``: event and
   profiled device time, bound, plain version, ``torch.sparse.mm``), and
   times each kernel, its plain version and one PyTorch library call that
   computes the same function, with CUDA events, and prints them as a
   ``{"kernels": [...]}`` line (twelve rows, K13's from phase 3d, K1's
   with ``per_launch``);
5. prints ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device it exits 1 and prints no result.

``python3 chip_smoke.py --k1`` prints only K1's ``k1_times`` and the
times of the steps that launch it (stencil, hybrid85, stencil p=16,
sharded-dia fwd+bwd; wall and profiled device time) as one
``k1_compare`` line.  Copied into an unpacked checkout of another commit
(``git archive``) and run from there, it measures that commit's K1 the
same way, so two commits compare on one card in turns.
"""

import contextlib
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
LSE_CHUNK = ("lse_rows", "lse_rows_bwd")
FUSED = ("chunk_bwd_pass1", "chunk_bwd_pass2")
GRAD_TOL = (1e-4, 1e-6)  # (rtol, atol): LSE gradients, the JAX tests' own
FAST_REL = 1e-2  # |gradB - split| / |split| with V stored in bfloat16
ROUTES = []             # triangular-solve routes taken, in order
PLAIN_K1 = [0]          # K1's plain version called by its wrapper
K1_PS = (128, 16, 1)    # K1's widths on the main path: stencil, p=16, matvec


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


def device_ms(fn, kernel, reps=20):
    """Device time per call of ``fn`` in kernels whose name holds
    ``kernel`` (all of them for ""), by torch.profiler: the kernels' own
    time, where the event time of a short kernel is the host's launch
    rate."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    return us / reps / 1e3


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
    from torchsparsegradutils_tpu_torch.kernels.chunk_lse import (
        lse_rows, lse_rows_bwd)
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_bwd_pass1, chunk_bwd_pass2, chunk_sddmm, chunk_spmm,
        chunk_spmm_slab, chunk_spmv)
    from torchsparsegradutils_tpu_torch.kernels.dia import (sddmm_core,
                                                            spmm_core)
    from torchsparsegradutils_tpu_torch.kernels.dia_tri import tri_dia_core
    from torchsparsegradutils_tpu_torch.kernels.window_gather import (
        window_gather)
    return {"dia_spmm": spmm_core, "dia_sddmm": sddmm_core,
            "gather": window_gather, "chunk_spmm": chunk_spmm,
            "chunk_sddmm": chunk_sddmm, "chunk_spmv": chunk_spmv,
            "tri_dia": tri_dia_core, "lse_rows": lse_rows,
            "lse_rows_bwd": lse_rows_bwd, "chunk_bwd_pass1": chunk_bwd_pass1,
            "chunk_bwd_pass2": chunk_bwd_pass2,
            "chunk_spmm_slab": chunk_spmm_slab}


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


def count_plain_k1():
    """Count calls of K1's plain version made through the kernels module
    (the wrapper's CPU path) in ``PLAIN_K1``: a step on the card must
    make none."""
    from torchsparsegradutils_tpu_torch.kernels import dia
    plain = dia.spmm_core_plain

    def counted(*a, **k):
        PLAIN_K1[0] += 1
        return plain(*a, **k)
    dia.spmm_core_plain = counted


def zero_counters():
    for fn in counters().values():
        fn.launches = 0
    PLAIN_K1[0] = 0


def read_counters(label, expect, forbid=()):
    """Launch counts since :func:`zero_counters`; raises if a kernel of
    ``expect`` did not launch or one of ``forbid`` did."""
    import torch
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    launches["dia_spmm_plain"] = PLAIN_K1[0]
    print(f"  {label}: launches {launches}")
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} never launched")
    if "dia_spmm" in expect:
        forbid = tuple(forbid) + ("dia_spmm_plain",)
    wrong = [k for k in forbid if launches[k] != 0]
    if wrong:
        raise AssertionError(f"{label}: kernels {wrong} launched off their "
                             "route")
    return launches


def fwd_bwd(A, B, G, backend, **kw):
    import torch
    from torchsparsegradutils_tpu_torch import sparse_mm
    v = A.values.detach().clone().requires_grad_(True)
    b = B.detach().clone().requires_grad_(True)
    out = sparse_mm(A.with_data(v), b, backend=backend, **kw)
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


def k1_repeat_close(label, offs, grid, B, geo, dt_name):
    """K1 on (offs, grid, B) twice (bitwise equal), against its plain
    version; returns the max abs error."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.dia import (spmm_core,
                                                            spmm_core_plain)
    got = spmm_core(offs, grid, B, geo)
    if not torch.equal(got, spmm_core(offs, grid, B, geo)):
        raise AssertionError(f"dia_spmm {label} [{dt_name}]: two launches "
                             "differ")
    return close(f"dia_spmm {label} (repeats bitwise)", got,
                 spmm_core_plain(offs, grid, B), dt_name)


def k1_awkward(A):
    """K1's awkward set: ``(label, geometry, p, lead)``; ``lead`` > 0
    passes B as a contiguous view that many elements into its storage
    (not 16-byte aligned)."""
    import numpy as np
    from torchsparsegradutils_tpu_torch.kernels.dia import DiaGeometry
    from torchsparsegradutils_tpu_torch.parallel.dia_sharded import (
        ShardedDia)
    def geo(offs, n, m):
        return DiaGeometry(np.array(offs), n, m)
    near = [-300, -2, -1, 0, 1, 2, 300]
    return [
        ("isolated offsets", geo([-5000, -1000, 0, 700, 3000], 8000, 8000),
         64, 0),
        ("a run of 256 offsets", geo(range(-128, 128), 3000, 3000), 32, 0),
        ("n < m", geo(near, 2000, 5000), 128, 0),
        ("n > m", geo(near, 5000, 2000), 128, 0),
        ("p=3", geo(near, 4000, 4000), 3, 0),
        ("p=130", geo(near, 4000, 4000), 130, 0),
        ("offsets beyond +-m", geo([-9000, -1, 0, 1, 9000], 4000, 4000),
         16, 0),
        ("unaligned B", geo(near, 4000, 4000), 128, 1),
        ("sharded-dia window", ShardedDia(A, 4).geo, 128, 0),
    ]


def check_k1(A, plan, grid, B, G, gen, dev):
    """K1 against its plain version in three dtypes, each launch twice
    and bitwise equal: at the cfd2 stencil for A @ B and Aᵀ G at each p
    of ``K1_PS``, and on :func:`k1_awkward`'s set.  Prints the window
    tables of the stencil and its transpose; returns the max f32 error."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.dia import spmm_tile
    geo = plan.geo
    _, rows, _, cap, count = spmm_tile(B)
    print(json.dumps({"k1_windows": {
        "rows_per_tile": rows, "cap": cap, "max_count": count,
        "stencil": geo.windows(rows, cap, count).tolist(),
        "stencil_T": geo.T.windows(rows, cap, count).tolist()}}))
    err = 0.0
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        name = str(dt).removeprefix("torch.")
        g = grid.to(dt)
        gt = geo.shift(g)
        for p in K1_PS:
            b, gg = B[:, :p].contiguous().to(dt), G[:, :p].contiguous().to(dt)
            e = max(k1_repeat_close(f"A@B p={p}", geo.offsets_on(dev), g, b,
                                    geo, name),
                    k1_repeat_close(f"A^T G p={p}", geo.T.offsets_on(dev), gt,
                                    gg, geo.T, name))
            if dt == torch.float32:
                err = max(err, e)
        for label, ag, p, lead in k1_awkward(A):
            ga = torch.randn(ag.n, ag.K, generator=gen).to(dev, dt)
            ba = torch.randn(lead + ag.m * p, generator=gen).to(dev, dt)
            ba = ba[lead:].view(ag.m, p)
            if lead and ba.data_ptr() % 16 == 0:
                raise AssertionError("unaligned B: the view is aligned")
            k1_repeat_close(label, ag.offsets_on(dev), ga, ba, ag, name)
    return err


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


def distinct_keys(rng, space, k):
    """``k`` distinct integers of ``[0, space)``, sorted."""
    import numpy as np
    keys = np.unique(rng.integers(0, space, k + k // 8 + 16))
    while len(keys) < k:
        keys = np.unique(np.concatenate([keys, rng.integers(0, space, k)]))
    return np.sort(rng.choice(keys, k, replace=False))


def skewed_pattern(n, hub_every=100, hub_len=1250, rest=1_544_148, seed=7):
    """Row-major (rows, cols), n x n: every ``hub_every``-th row a hub of
    ``hub_len`` distinct uniform columns, ``rest`` distinct uniform pairs
    over the other rows.  At n = 123,440: 1,235 hubs holding 1,543,750
    entries and 3,087,898 in all; the longest row is 50x the mean, so
    the ELL grid refuses the rows and takes the columns."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hubs = np.arange(0, n, hub_every)
    hub_cols = np.concatenate([np.sort(rng.choice(n, hub_len, replace=False))
                               for _ in hubs])
    others = np.setdiff1d(np.arange(n), hubs)
    keys = distinct_keys(rng, len(others) * n, rest)
    rows = np.concatenate([np.repeat(hubs, hub_len), others[keys // n]])
    cols = np.concatenate([hub_cols, keys % n])
    order = np.lexsort((cols, rows))
    return rows[order], cols[order]


def lse_awkward_plan():
    """(3000, 200,000): empty rows, a single entry, rows of 1,024 and
    1,025 entries (either side of the kernels' whole-block threshold),
    one of 100,000; and its values with +inf, -inf and an all -inf
    row."""
    import numpy as np
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        build_chunk_plan)
    from torchsparsegradutils_tpu_torch.types import StaticArray
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
    vals[rows == 10] = -np.inf
    vals[np.flatnonzero(rows == 11)[:1]] = np.inf
    vals[np.flatnonzero(rows == 5)[::997]] = -np.inf
    return build_chunk_plan(StaticArray(rows), StaticArray(cols), n, m), vals


def close_inf(name, got, ref, dtype_name, tol=None):
    """:func:`close` on the finite entries of ``ref``; the infinities
    must be equal."""
    import torch
    got, ref = got.double(), ref.double()
    fin = torch.isfinite(ref)
    if got.shape != ref.shape or not torch.equal(got[~fin], ref[~fin]):
        raise AssertionError(f"{name} [{dtype_name}]: shapes or "
                             "infinities differ")
    return close(name, got[fin], ref[fin], dtype_name, tol)


def check_lse_kernels(label, plan, vals, width, dt_name, gen):
    """K10 (both include_zeros) and K11 against their plain versions,
    each launched twice and bitwise equal; returns the largest errors.
    The plain versions run in float64 on the same values: a float32
    index_add over a 100,000-entry row is itself off by about 1e-5
    relative, in an order that changes from run to run."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels import _build
    from torchsparsegradutils_tpu_torch.kernels.chunk_lse import (
        lse_rows, lse_rows_bwd, lse_rows_bwd_plain, lse_rows_plain)
    ip = plan.maps(vals.device)["indptr"]
    g = torch.randn(plan.n, generator=gen).to(
        vals.device, _build.acc_dtype(vals.dtype))
    err = {}
    for iz in (False, True):
        out, again = (lse_rows(ip, vals, width, iz) for _ in range(2))
        if not torch.equal(out, again):
            raise AssertionError(f"{label} lse_rows [{dt_name}]: two "
                                 "launches differ")
        ref = lse_rows_plain(ip, vals.double(), width, iz)
        e = close_inf(f"{label} lse_rows include_zeros={iz} (repeats "
                      "bitwise)", out, ref, dt_name)
        err["lse_rows"] = max(err.get("lse_rows", 0.0), e)
        d, d2 = (lse_rows_bwd(ip, vals, out, g) for _ in range(2))
        if not torch.equal(d, d2):
            raise AssertionError(f"{label} lse_rows_bwd [{dt_name}]: two "
                                 "launches differ")
        e = close(f"{label} lse_rows_bwd include_zeros={iz} (repeats "
                  "bitwise)", d, lse_rows_bwd_plain(
                      ip, vals.double(), out.double(), g.double()), dt_name)
        err["lse_rows_bwd"] = max(err.get("lse_rows_bwd", 0.0), e)
    return err


def check_fused_kernels(label, plan, vals, B, G, dt_name):
    """K12a and K12b against their plain versions, V in the working dtype
    and in bfloat16, each launched twice and bitwise equal; gradA equal
    to K7's; returns the largest errors."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_bwd_pass1, chunk_bwd_pass1_plain, chunk_bwd_pass2,
        chunk_bwd_pass2_plain, chunk_sddmm)
    d, dt = plan.maps(B.device), plan.T.maps(B.device)
    err = {}
    for v_dtype in dict.fromkeys((B.dtype, torch.bfloat16)):
        vn = str(v_dtype).removeprefix("torch.")
        args = (d["indptr"], d["cols"], vals, B, G, v_dtype)
        (dd, V), (dd2, V2) = chunk_bwd_pass1(*args), chunk_bwd_pass1(*args)
        if not (torch.equal(dd, dd2) and torch.equal(V, V2)):
            raise AssertionError(f"{label} chunk_bwd_pass1 [{dt_name}]: two "
                                 "launches differ")
        pdd, pV = chunk_bwd_pass1_plain(*args)
        if not torch.equal(dd, chunk_sddmm(d["indptr"], d["cols"], G, B)):
            raise AssertionError(f"{label} chunk_bwd_pass1 [{dt_name}]: dd "
                                 "is not K7's")
        e = max(close(f"{label} chunk_bwd_pass1 dd, V {vn} (repeats "
                      "bitwise)", dd, pdd, dt_name),
                close(f"{label} chunk_bwd_pass1 V {vn}", V, pV, dt_name))
        del pV
        err["chunk_bwd_pass1"] = max(err.get("chunk_bwd_pass1", 0.0), e)
        dB, dB2 = (chunk_bwd_pass2(dt["indptr"], dt["perm"], V, B.dtype)
                   for _ in range(2))
        if not torch.equal(dB, dB2):
            raise AssertionError(f"{label} chunk_bwd_pass2 [{dt_name}]: two "
                                 "launches differ")
        e = close(f"{label} chunk_bwd_pass2 V {vn} (repeats bitwise)", dB,
                  chunk_bwd_pass2_plain(dt["indptr"], dt["perm"], V,
                                        B.dtype), dt_name)
        err["chunk_bwd_pass2"] = max(err.get("chunk_bwd_pass2", 0.0), e)
        del V, V2
    return err


def lse_fwd_bwd(A, backend):
    """dim 1, dim 0 and the bidir LSE of A and the gradient of their
    weighted sum (fixed weights) w.r.t. A.values."""
    import torch
    from torchsparsegradutils_tpu_torch import (sparse_bidir_logsumexp,
                                                sparse_logsumexp)
    v = A.values.detach().clone().requires_grad_(True)
    M = A.with_data(v)
    outs = [sparse_logsumexp(M, 1, backend=backend),
            sparse_logsumexp(M, 0, include_zeros=False, backend=backend),
            *sparse_bidir_logsumexp(M, backend=backend)]
    cts = [torch.linspace(-1, 1, o.numel(), device=v.device) for o in outs]
    (gv,) = torch.autograd.grad(outs, v, cts)
    return outs, gv


def drive_lse(label, A, expect, forbid):
    """The LSE ops forward and backward through the public entries on
    ``auto``, the counters set to 0 just before and read just after; then
    the segment path on the card as reference."""
    zero_counters()
    outs, gv = lse_fwd_bwd(A, "auto")
    launches = read_counters(label, expect, forbid)
    ref_outs, ref_gv = lse_fwd_bwd(A, "xla")
    for name, got, ref in zip(("dim 1", "dim 0 (support)", "bidir col",
                               "bidir row"), outs, ref_outs):
        close_inf(f"{label} {name} vs segment path", got, ref, "float32",
                  (1e-5, 1e-6))
    close(f"{label} gradA vs segment path", gv, ref_gv, "float32", GRAD_TOL)
    return launches


def slab_bound(plan, s, p, es):
    """Bound of K13 on slab ``s`` of a sharded chunk plan: its values,
    columns and row pointers, the distinct B rows it reads and its output
    slab, each moved once, or its 2 nnz p operations."""
    import numpy as np
    lo, hi = int(plan.bounds[s]), int(plan.bounds[s + 1])
    rps = plan.rows_per_shard
    ucols = len(np.unique(plan.cols[lo:hi]))
    return bound((hi - lo) * (es + 8) + (rps + 1) * 8
                 + (ucols + rps) * p * es, 2 * (hi - lo) * p)


def check_slab_kernel(label, indptr, cols, vals, B, slabs, dt_name,
                      whole=None):
    """K13 on each ``(row0, rps)`` of ``slabs`` against its plain version,
    launched twice and bitwise equal; with ``whole`` (K6's output on the
    same operands) each slab's rows also bitwise equal to K6's, as the
    two share their row loop.  Returns the largest error."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_spmm_slab, chunk_spmm_slab_plain)
    n = indptr.shape[0] - 1
    err = 0.0
    for row0, rps in slabs:
        args = (indptr, cols, vals, B, row0, rps)
        got, again = chunk_spmm_slab(*args), chunk_spmm_slab(*args)
        if not torch.equal(got, again):
            raise AssertionError(f"{label} K13 slab {row0}+{rps} "
                                 f"[{dt_name}]: two launches differ")
        inside = max(0, min(rps, n - row0))
        if got[inside:].any():
            raise AssertionError(f"{label} K13 slab {row0}+{rps}: padding "
                                 "rows are not 0")
        if whole is not None and not torch.equal(
                got[:inside], whole[row0:row0 + inside]):
            raise AssertionError(f"{label} K13 slab {row0}+{rps} "
                                 f"[{dt_name}]: rows differ from K6's")
        err = max(err, close(f"{label} K13 rows {row0}..{row0 + rps} "
                             "(repeats bitwise)", got,
                             chunk_spmm_slab_plain(*args), dt_name))
    return err


def grads_close(label, got, ref, what=("out", "gradA", "gradB")):
    for name, g, r in zip(what, got, ref):
        close(f"{label} {name}", g, r, "float32")


def chained_step(fn, v0, b0, G, eps=1e-6):
    """A step of ``fn(v, b)`` forward and backward for the cotangent G,
    whose gradients feed the next step's inputs (so steps chain)."""
    import torch
    state = {"v": v0.detach().clone(), "b": b0.detach().clone()}

    def step():
        v = state["v"].requires_grad_(True)
        b = state["b"].requires_grad_(True)
        gv, gb = torch.autograd.grad(fn(v, b), (v, b), G)
        state["v"] = (v + eps * gv).detach()
        state["b"] = (b + eps * gb).detach()
    return step


@contextlib.contextmanager
def one_rank_group(dev):
    """A one-rank NCCL group on a ``FileStore`` in a temporary directory
    (no network), destroyed on exit."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(dev)
    tmp = tempfile.mkdtemp(prefix="tsgu_nccl_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_parallel(R, A, B, G, gen, dev, card):
    """Phase 3d: ``parallel/`` on a one-rank NCCL group.

    K13 against its plain version at the cfd2 shapes (each slab of a
    4-shard plan and the whole matrix as one slab; three dtypes) and on
    the small awkward and uneven plans at p = 3; ``sharded_chunk_spmm``,
    ``sharded_sparse_mm`` and ``sharded_dia_spmm`` forward and backward
    through their entry points at world size 1 and as the 4-shard
    layout's per-rank bodies, against the unsharded ``sparse_mm``; the
    flagship train step at full width against the unsharded step; and
    their times.  Returns K13's row of the ``kernels`` line."""
    with one_rank_group(dev):
        return parallel_checks(R, A, B, G, gen, dev, card)


def k1_times(A, plan, grid, B, G, dev):
    """K1's time per launch (CUDA events, and the kernel's profiled device
    time) for A @ B at each p of ``K1_PS`` and for Aᵀ G at p = 128, each
    beside its bound, its plain version and ``torch.sparse.mm`` on the
    same CSR (of A or Aᵀ)."""
    import inspect

    import torch
    from torchsparsegradutils_tpu_torch.kernels.dia import (spmm_core,
                                                            spmm_core_plain)
    # a checkout from before the window table passes no geometry
    with_geo = "geo" in inspect.signature(spmm_core).parameters
    geo = plan.geo
    n, m, K = A.shape[0], A.shape[1], plan.K
    cells = valid_cells(plan.offsets.tolist(), n, m)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr_np().astype("int64")).to(dev),
        A.cols_t(), A.values, (n, m))
    csr_t = csr.to_sparse_coo().t().coalesce().to_sparse_csr()
    gt = geo.shift(grid)
    out = {}
    for label, gm, gr, X, lib in (
            [(f"p{p}", geo, grid, B[:, :p].contiguous(), csr) for p in K1_PS]
            + [("transpose_p128", geo.T, gt, G, csr_t)]):
        offs = gm.offsets_on(dev)
        kw = {"geo": gm} if with_geo else {}
        p = X.shape[1]
        b_ms, b_by = bound((n * K + m * p + n * p) * 4 + K * 8,
                           2 * cells * p)
        out[label] = {
            "ms": time_ms(lambda: spmm_core(offs, gr, X, **kw)),
            "device_ms": device_ms(lambda: spmm_core(offs, gr, X, **kw),
                                   "dia_spmm_kernel"),
            "plain_ms": time_ms(lambda: spmm_core_plain(offs, gr, X),
                                reps=5),
            "library_ms": time_ms(lambda: torch.sparse.mm(lib, X)),
            "bound_ms": b_ms, "bound_by": b_by}
    return out


def k1_compare() -> int:
    """``--k1``: K1's times (:func:`k1_times`) and the times of the steps
    that launch it (stencil, hybrid85, stencil p=16, sharded-dia fwd+bwd),
    nothing else: run in turns from two checkouts to compare them on one
    card.  Prints one JSON line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from torchsparsegradutils_tpu_torch import sparse_mm
    from torchsparsegradutils_tpu_torch.kernels import _build
    from torchsparsegradutils_tpu_torch.kernels.dia import (build_dia_plan,
                                                            values_to_grid)
    from torchsparsegradutils_tpu_torch.parallel import sharded_dia_spmm
    from torchsparsegradutils_tpu_torch.utils.random_sparse import (
        hybrid_sparse, stencil_sparse)
    dev = torch.device("cuda", 0)
    card = smi_line()
    _build.libraries()
    gen = torch.Generator().manual_seed(0)
    A = stencil_sparse((N, N), STENCIL_OFFSETS, generator=gen, device=dev)
    plan = build_dia_plan(A.row_sa(), A.col_sa(), N, N)
    B = torch.randn(N, P, generator=gen).to(dev)
    G = torch.randn(N, P, generator=gen).to(dev)
    H = hybrid_sparse((N, N), STENCIL_OFFSETS, NNZ_HYBRID, dia_coverage=0.85,
                      generator=gen, device=dev)
    res = {"k1": k1_times(A, plan, values_to_grid(plan, A.values), B, G,
                          dev)}

    def step(M, p):
        return chained_step(lambda v, b: sparse_mm(M.with_data(v), b),
                            M.values, B[:, :p].contiguous(),
                            G[:, :p].contiguous())
    steps = {}
    with one_rank_group(dev):
        f = sharded_dia_spmm(A)
        for label, fn in (("stencil", step(A, P)), ("hybrid85", step(H, P)),
                          ("stencil_p16", step(A, 16)),
                          ("sharded_dia", chained_step(f, A.values, B, G))):
            steps[f"{label}_fwd_bwd_ms"] = time_ms(fn, reps=50)
            # the device's share, which the host's pace does not move
            steps[f"{label}_fwd_bwd_device_ms"] = device_ms(fn, "", reps=10)
    res["steps"] = steps
    print(json.dumps({"k1_compare": res, "card": card}))
    return 0


def parallel_checks(R, A, B, G, gen, dev, card):
    """The body of :func:`phase_parallel`, on its one-rank group."""
    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch import sparse_mm
    from torchsparsegradutils_tpu_torch.kernels import chunk_spmm as cs
    from torchsparsegradutils_tpu_torch.parallel import (
        build_sharded_chunk_plan, init_params, loss_fn, make_model,
        make_train_step, shard_rows, sharded_chunk_spmm, sharded_dia_spmm,
        sharded_sparse_mm)
    from torchsparsegradutils_tpu_torch.parallel.chunk_sharded import (
        slab_spmm)
    from torchsparsegradutils_tpu_torch.parallel.dia_sharded import (
        ShardedDia)
    from torchsparsegradutils_tpu_torch.parallel.sharding import shard_spmm

    # ---- K13 against its plain version ------------------------------------
    n, m = R.shape
    plan4 = build_sharded_chunk_plan(R, 4)
    plan1 = build_sharded_chunk_plan(R, 1)
    rps4 = plan4.rows_per_shard
    slabs = [(s * rps4, rps4) for s in range(4)] + [(0, n)]
    d = plan1.maps(dev)
    err = 0.0
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        name = str(dt).removeprefix("torch.")
        vals, b = R.values.to(dt), B.to(dt)
        whole = cs.chunk_spmm(d["indptr"], d["cols"], vals, b)
        e = check_slab_kernel("random cfd2 p=128", d["indptr"], d["cols"],
                              vals, b, slabs, name, whole)
        del whole
        small = awkward_pattern()                 # 700 x 6000, p = 3
        sd = small.maps(dev)
        sv = torch.randn(small.nnz, generator=gen).to(dev, dt)
        sB = torch.randn(small.m, 3, generator=gen).to(dev, dt)
        check_slab_kernel("small awkward p=3", sd["indptr"], sd["cols"], sv,
                          sB, [(78 * s, 78) for s in range(9)]
                          + [(0, 700), (702, 8)], name)
        # tests/test_parallel.py's uneven case: 5 entries in 62 rows, 4
        # slabs of 16 (two of them empty, the last past n)
        ui = torch.tensor([0, 2, 3, 3, 3, 3, 4] + [4] * 55 + [5],
                          device=dev)
        uc = torch.tensor([1, 3, 2, 0, 4], device=dev)
        uv = torch.arange(1.0, 6.0, device=dev).to(dt)
        check_slab_kernel("uneven 62x5 p=3", ui, uc, uv,
                          torch.randn(5, 3, generator=gen).to(dev, dt),
                          [(16 * s, 16) for s in range(4)], name)
        if dt == torch.float32:
            err = e

    # ---- the sharded ops through their entry points -----------------------
    ref = fwd_bwd(R, B, G, "auto")                 # unsharded, chunk engine
    plain_calls = []
    plain = cs.chunk_spmm_slab_plain

    def counted_plain(*args):
        plain_calls.append(1)
        return plain(*args)
    cs.chunk_spmm_slab_plain = counted_plain
    try:
        zero_counters()
        v = R.values.detach().clone().requires_grad_(True)
        b = B.detach().clone().requires_grad_(True)
        out = sharded_chunk_spmm(plan1, v, b)
        got = (out, *torch.autograd.grad(out, (v, b), G))
        launches = read_counters("sharded-chunk p=128 (world size 1)",
                                 ("chunk_spmm_slab", "chunk_sddmm",
                                  "chunk_spmm", "gather"))
    finally:
        cs.chunk_spmm_slab_plain = plain
    if plain_calls:
        raise AssertionError("sharded-chunk: K13's plain version ran "
                             f"{len(plain_calls)} times on the card")
    grads_close("sharded-chunk vs unsharded sparse_mm", got, ref)
    v = R.values.detach().clone().requires_grad_(True)
    b = B.detach().clone().requires_grad_(True)
    out = torch.cat([slab_spmm(plan4, r, v, b) for r in range(4)])[:n]
    grads_close("sharded-chunk 4-rank bodies vs unsharded",
                (out, *torch.autograd.grad(out, (v, b), G)), ref)

    for S in (1, 4):
        M = shard_rows(R, S)
        data = M.data.detach().clone().requires_grad_(True)
        b = B.detach().clone().requires_grad_(True)
        zero_counters()
        if S == 1:
            M.data = data
            out = sharded_sparse_mm(M, b)
        else:
            out = torch.cat([shard_spmm(M, r, data, b)
                             for r in range(S)])[:n]
        gd, gb = torch.autograd.grad(out, (data, b), G)
        read_counters(f"sharded-sparse-mm S={S}", CHUNK_KERNELS)
        sel = torch.from_numpy(np.concatenate(
            [np.flatnonzero(M.mask[s]) + s * M.mask.shape[1]
             for s in range(S)])).to(dev)
        grads_close(f"sharded_sparse_mm S={S} vs unsharded",
                    (out, gd.reshape(-1)[sel], gb), ref)
    del ref, got, out

    ref = fwd_bwd(A, B, G, "auto")                 # unsharded, DIA engine
    f = sharded_dia_spmm(A)
    b = torch.nn.functional.pad(B, (0, 0, 0, f.n_padded - n))
    v = A.values.detach().clone().requires_grad_(True)
    b = b.requires_grad_(True)
    zero_counters()
    out = f(v, b)
    gv, gb = torch.autograd.grad(out, (v, b), torch.nn.functional.pad(
        G, (0, 0, 0, f.n_padded - n)))
    read_counters("sharded-dia p=128 (world size 1)", DIA_KERNELS)
    grads_close("sharded_dia_spmm vs unsharded", (out[:n], gv, gb[:n]), ref)
    L4 = ShardedDia(A, 4)
    v = A.values.detach().clone().requires_grad_(True)
    b = B.detach().clone().requires_grad_(True)
    out = torch.cat([L4.slab_spmm(v, L4.window(b, r), r)
                     for r in range(4)])[:n]
    print(f"  sharded-dia 4 slabs: rows_per_shard {L4.rows_per_shard}, "
          f"halo {L4.halo}")
    grads_close("sharded-dia 4-rank windows vs unsharded",
                (out, *torch.autograd.grad(out, (v, b), G)), ref)
    del ref, out

    # ---- the flagship train step at full width ----------------------------
    enc = make_model((1, 48, 48, 48), radius=1.5)
    nv = enc.volume_numel
    print(f"  flagship: {nv} voxels, {len(enc.offsets)} lower offsets, "
          f"{enc.nnz} entries, 128 observations")
    params = init_params(enc, torch.Generator().manual_seed(0), dev)
    x = torch.randn(128, nv, generator=gen)
    x[:, 1:] += 0.5 * x[:, :-1].clone()            # a correlated Gaussian
    x = x.to(dev)
    lr = 1e-2
    step = make_train_step(enc, 1, 1, lr=lr)
    leaves = {k: t.clone().requires_grad_(True) for k, t in params.items()}
    loss_ref = loss_fn(leaves, x, enc)
    grads = torch.autograd.grad(loss_ref, list(leaves.values()))
    losses, p = [], params
    for i in range(5):
        p, loss = step(p, x)
        losses.append(loss.item())
        if i == 0:
            rel = abs(losses[0] - loss_ref.item()) / abs(loss_ref.item())
            print(f"  flagship step 1: loss {losses[0]:.6f}, unsharded "
                  f"{loss_ref.item():.6f} (relative {rel:.2e})")
            if not rel <= 1e-5:
                raise AssertionError("flagship step 1 loss differs from the "
                                     "unsharded step")
            for (k, t), g in zip(leaves.items(), grads):
                close(f"flagship step 1 {k} vs unsharded step", p[k],
                      (t - lr * g).detach(), "float32", (1e-4, 1e-5))
    print(f"  flagship losses: {losses}")
    if not (np.isfinite(losses).all() and (np.diff(losses) < 0).all()):
        raise AssertionError(f"flagship loss not finite and decreasing: "
                             f"{losses}")

    # ---- timing -------------------------------------------------------------
    es = 4
    times = {}
    for S, plan in ((1, plan1), (4, plan4)):
        pd = plan.maps(dev)
        for s in range(S):
            rps = plan.rows_per_shard
            lo, hi = int(plan.bounds[s]), int(plan.bounds[s + 1])
            sp = plan.slab_plan(s)
            csr = torch.sparse_csr_tensor(
                torch.from_numpy(sp.indptr).to(dev),
                torch.from_numpy(sp.cols).to(dev), R.values[lo:hi],
                (rps, m))
            args = (pd["indptr"], pd["cols"], R.values, B, s * rps, rps)
            b_ms, b_by = slab_bound(plan, s, B.shape[1], es)
            times[f"S{S}_slab{s}"] = {
                "entries": hi - lo,
                "ms": time_ms(lambda: cs.chunk_spmm_slab(*args)),
                "plain_ms": time_ms(lambda: cs.chunk_spmm_slab_plain(*args)),
                "library_ms": time_ms(lambda: torch.sparse.mm(csr, B)),
                "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps({"k13_slabs": times, "card": card}))

    steps = {
        "unsharded_random_fwd_bwd_ms": chained_step(
            lambda v, b: sparse_mm(R.with_data(v), b), R.values, B, G),
        "sharded_chunk_fwd_bwd_ms": chained_step(
            lambda v, b: sharded_chunk_spmm(plan1, v, b), R.values, B, G),
        "sharded_chunk_4_bodies_fwd_bwd_ms": chained_step(
            lambda v, b: torch.cat([slab_spmm(plan4, r, v, b)
                                    for r in range(4)])[:n], R.values, B, G),
        "unsharded_stencil_fwd_bwd_ms": chained_step(
            lambda v, b: sparse_mm(A.with_data(v), b), A.values, B, G),
        "sharded_dia_fwd_bwd_ms": chained_step(
            lambda v, b: f(v, b), A.values, B, G),
    }
    state = {"p": params}

    def train_step():
        state["p"], _ = step(state["p"], x)

    def unsharded_step():
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in state["p"].items()}
        grads = torch.autograd.grad(loss_fn(leaves, x, enc),
                                    list(leaves.values()))
        state["p"] = {k: (t - lr * g).detach()
                      for (k, t), g in zip(leaves.items(), grads)}

    res = {k: time_ms(fn, reps=20) for k, fn in steps.items()}
    res["flagship_train_step_ms"] = time_ms(train_step, reps=10)
    res["flagship_unsharded_step_ms"] = time_ms(unsharded_step, reps=10)
    res["flagship_losses"] = losses
    print(json.dumps({"parallel_steps": res, "card": card}))
    profile_step("sharded_chunk_fwd_bwd_step",
                 steps["sharded_chunk_fwd_bwd_ms"])
    profile_step("flagship_train_step", train_step, steps=3)

    whole = times["S1_slab0"]
    return {"name": "chunk_spmm_slab", "route": "cuda",
            "source": "torchsparsegradutils_tpu_torch/csrc/chunk_spmm.cu",
            "replaces": "torchsparsegradutils_tpu/parallel/chunk_sharded.py"
                        ":146 (K13 _sharded_chunk_fwd)",
            "launches": launches["chunk_spmm_slab"], "max_abs_err": err,
            "ms": whole["ms"], "plain_ms": whole["plain_ms"],
            "bound_ms": whole["bound_ms"], "bound_by": whole["bound_by"],
            "library_ms": whole["library_ms"],
            "slabs_of_4": [times[f"S4_slab{s}"] for s in range(4)]}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from torchsparsegradutils_tpu_torch import (SparseCSR,
                                                sparse_bidir_logsumexp,
                                                sparse_logsumexp, sparse_mm)
    from torchsparsegradutils_tpu_torch.kernels import _build, dia
    from torchsparsegradutils_tpu_torch.kernels.chunk_lse import (
        lse_rows, lse_rows_bwd, lse_rows_bwd_plain, lse_rows_plain)
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        build_chunk_plan, chunk_bwd_pass1, chunk_bwd_pass1_plain,
        chunk_bwd_pass2, chunk_bwd_pass2_plain, chunk_sddmm,
        chunk_sddmm_plain, chunk_spmm, chunk_spmm_plain, chunk_spmv,
        chunk_spmv_plain)
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
    t1 = time.perf_counter()
    s_rows, s_cols = skewed_pattern(N)
    s_indptr = np.concatenate([[0], np.cumsum(np.bincount(s_rows,
                                                          minlength=N))])
    S = SparseCSR(s_indptr, s_cols, torch.randn(len(s_cols), generator=gen),
                  (N, N), device=dev)
    splan = build_chunk_plan(S.row_sa(), S.col_sa(), N, N)
    print(f"  lse-skewed: {S.nnz} entries, longest row "
          f"{int(np.diff(s_indptr).max())}, built in "
          f"{time.perf_counter() - t1:.1f} s")
    lplan, lvals = lse_awkward_plan()
    e1 = check_k1(A, plan, grid, B, G, gen, dev)
    err = {}
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        name = str(dt).removeprefix("torch.")
        g, b, gg = grid.to(dt), B.to(dt), G.to(dt)
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
            err = {"dia_spmm": e1, "dia_sddmm": e3, "gather": 0.0, **ec}
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
        # the chunk LSE kernels on the skewed and random rows and a small
        # awkward pattern; the fused backward at p = 128 and p = 3
        el = {}
        for label, pl, vv in (("lse-skewed cfd2", splan, S.values),
                              ("lse-random cfd2", cplan, R.values)):
            for k, e in check_lse_kernels(label, pl, vv.to(dt), N, name,
                                          gen).items():
                el[k] = max(el.get(k, 0.0), e)
        check_lse_kernels("lse small awkward", lplan,
                          torch.from_numpy(lvals).to(dev, dt), lplan.m,
                          name, gen)
        ef = check_fused_kernels("random cfd2 p=128", cplan, R.values.to(dt),
                                 b, gg, name)
        check_fused_kernels("small p=3", small, sv, sB, sX, name)
        if dt == torch.float32:
            err.update(el)
            err.update(ef)

    # ---- phase 3: the main path --------------------------------------------
    count_plain_k1()
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

    print(f"phase 3c: sparse_logsumexp / sparse_bidir_logsumexp fwd+bwd "
          f"and the fused chunk backward ({time.perf_counter() - t0:.1f} "
          "s in)")
    sd = small_r.todense().double()
    for iz in (True, False):
        dd_ = sd if iz else sd.masked_fill(small_r.todense() == 0,
                                           float("-inf"))
        for dim in (0, 1):
            close_inf(f"small random lse dim {dim} include_zeros={iz} vs "
                      "dense f64",
                      sparse_logsumexp(small_r, dim, include_zeros=iz),
                      torch.logsumexp(dd_, dim), "float32", (1e-5, 1e-6))
    drive_lse("lse-stencil", A, ("gather",), LSE_CHUNK)
    drive_lse("lse-random", R, ("gather",), LSE_CHUNK)
    launches_lse = drive_lse("lse-skewed", S, LSE_CHUNK + ("gather",), ())
    split = fwd_bwd(R, B, G, "auto")
    dia.SPMM_BWD = "fused"
    try:
        for gp in ("exact", "fast"):
            zero_counters()
            got = fwd_bwd(R, B, G, "auto", grad_precision=gp)
            lf = read_counters(f"random-fused p=128 {gp}", FUSED,
                               ("chunk_sddmm",))
            if lf["chunk_spmm"] != 1:
                raise AssertionError("random-fused: chunk_spmm launched "
                                     f"{lf['chunk_spmm']} times, not once "
                                     "(the forward)")
            if gp == "exact":
                launches_f = lf
            for name_, g_, r_ in zip(("out", "gradA", "gradB"), got, split):
                if (gp, name_) != ("fast", "gradB"):
                    close(f"random-fused {gp} {name_} vs split", g_, r_,
                          "float32")
                    continue
                rel = ((g_ - r_).norm() / r_.norm()).item()
                print(f"  random-fused fast gradB vs split: relative error "
                      f"{rel:.3e} (limit {FAST_REL})")
                if not rel <= FAST_REL:
                    raise AssertionError("random-fused fast gradB: relative "
                                         f"error {rel:.3e} > {FAST_REL}")
    finally:
        dia.SPMM_BWD = "split"
    del split, got

    print(f"phase 3d: parallel/ on a one-rank NCCL group "
          f"({time.perf_counter() - t0:.1f} s in)")
    k13_row = phase_parallel(R, A, B, G, gen, dev, card)

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
        return chained_step(lambda v, b: sparse_mm(A.with_data(v), b),
                            A.values, B, G, eps)

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
    # the LSE steps, and sparse_mm's fwd+bwd under the two backwards
    def lse_step(A, what):
        v = A.values.detach().clone().requires_grad_(what == "bidir_fwd_bwd")
        M = A.with_data(v)

        def step():
            if what == "bidir_fwd_bwd":
                outs = sparse_bidir_logsumexp(M)
                torch.autograd.grad(outs, v, outs)
                return
            with torch.no_grad():
                if what == "bidir_fwd":
                    sparse_bidir_logsumexp(M)
                else:
                    sparse_logsumexp(M, 1 if what == "dim1_fwd" else 0)
        return step

    for label, M in (("lse_stencil", A), ("lse_random", R),
                     ("lse_skewed", S)):
        for what in ("dim1_fwd", "dim0_fwd", "bidir_fwd", "bidir_fwd_bwd"):
            steps[f"{label}_{what}_ms"] = time_ms(lse_step(M, what), reps=20)
    for mode in ("split", "fused"):
        dia.SPMM_BWD = mode
        try:
            torch.cuda.reset_peak_memory_stats()
            base_mib = torch.cuda.memory_allocated() / 2**20
            steps[f"random_{mode}_fwd_bwd_ms"] = time_ms(chain_step(R, B, G),
                                                         reps=20)
            steps[f"random_{mode}_fwd_bwd_peak_extra_mib"] = \
                torch.cuda.max_memory_allocated() / 2**20 - base_mib
        finally:
            dia.SPMM_BWD = "split"
    print(json.dumps({"main_path": steps, "tri_random_host": host,
                      "card": card}))
    profile_step("lse_skewed_bidir_fwd_bwd_step",
                 lse_step(S, "bidir_fwd_bwd"))
    profile_step("tri_stencil_fwd_bwd_step", chain_tri(T, TB, GT,
                                                       upper=False), steps=3)
    profile_step("tri_random_fwd_bwd_step", chain_tri(TR, TB2, GT2,
                                                      upper=False), steps=3)
    profile_step("stencil_fwd_bwd_step", chain_step(A, B, G))
    profile_step("hybrid85_fwd_bwd_step", chain_step(H, B, G))
    profile_step("random_fwd_bwd_step", chain_step(R, B, G))
    profile_step("random_p1_fwd_bwd_step", chain_step(R, B1, G1))

    k1 = k1_times(A, plan, grid, B, G, dev)
    print(json.dumps({"k1_times": k1, "card": card}))
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
         lambda: spmm_core(offs, grid, B, plan.geo),
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
    # K10 and K11 on lse-skewed (include_zeros, as sparse_logsumexp's
    # default), K12a and K12b on the random pattern at p = 128
    sm = splan.maps(dev)
    nnz_s = S.nnz
    out_s = lse_rows(sm["indptr"], S.values, N, True)
    g_s = torch.randn(N, generator=gen).to(dev)
    coo_s = torch.sparse_coo_tensor(torch.stack([S.rows_t(), S.cols_t()]),
                                    S.values, (N, N)).coalesce()
    ctm = cplan.T.maps(dev)
    V = chunk_bwd_pass1(cm["indptr"], cm["cols"], R.values, B, G,
                        torch.float32)[1]
    csr_rt = torch.sparse_csr_tensor(ctm["indptr"], ctm["cols"],
                                     R.values[ctm["perm"]], (m, n))
    lse_src = "torchsparsegradutils_tpu_torch/csrc/chunk_lse.cu"
    fused_src = "torchsparsegradutils_tpu_torch/csrc/chunk_bwd_fused.cu"
    spec += [
        ("lse_rows", lse_src, "torchsparsegradutils_tpu/kernels/"
         "chunk_lse.py:70 (K10 _lse_partials)", launches_lse,
         lambda: lse_rows(sm["indptr"], S.values, N, True),
         lambda: lse_rows_plain(sm["indptr"], S.values, N, True),
         lambda: torch.sparse.log_softmax(coo_s, 1),
         bound(nnz_s * es + (n + 1) * 8 + n * es, 2 * nnz_s)),
        ("lse_rows_bwd", lse_src, "torchsparsegradutils_tpu/kernels/"
         "chunk_lse.py:142 (K11 _lse_bwd_pass)", launches_lse,
         lambda: lse_rows_bwd(sm["indptr"], S.values, out_s, g_s),
         lambda: lse_rows_bwd_plain(sm["indptr"], S.values, out_s, g_s),
         None, bound(2 * nnz_s * es + (n + 1) * 8 + 2 * n * es,
                     2 * nnz_s)),
        ("chunk_bwd_pass1", fused_src, "torchsparsegradutils_tpu/kernels/"
         "chunk_spmm.py:429 (K12a chunk_spmm_bwd_fused pass 1)", launches_f,
         lambda: chunk_bwd_pass1(cm["indptr"], cm["cols"], R.values, B, G,
                                 torch.float32),
         lambda: chunk_bwd_pass1_plain(cm["indptr"], cm["cols"], R.values,
                                       B, G, torch.float32),
         lambda: torch.sparse.sampled_addmm(csr_r, G, B.t(), beta=0.0),
         bound((urows + ucols) * P * es + idx_bytes + 2 * nnz_r * es
               + nnz_r * P * es, 3 * nnz_r * P)),
        ("chunk_bwd_pass2", fused_src, "torchsparsegradutils_tpu/kernels/"
         "chunk_spmm.py:462 (K12b chunk_spmm_bwd_fused pass 2)", launches_f,
         lambda: chunk_bwd_pass2(ctm["indptr"], ctm["perm"], V,
                                 torch.float32),
         lambda: chunk_bwd_pass2_plain(ctm["indptr"], ctm["perm"], V,
                                       torch.float32),
         lambda: torch.sparse.mm(csr_rt, G),
         bound(nnz_r * P * es + nnz_r * 8 + (m + 1) * 8 + m * P * es,
               nnz_r * P)),
    ]
    for name, source, replaces, lc, kern, plain, lib, (b_ms, b_by) in spec:
        reps = 5 if name == "tri_dia" else 20
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": lc[name],
            "max_abs_err": err[name], "ms": time_ms(kern, reps=reps),
            "plain_ms": time_ms(plain, reps=reps), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}
        if lib is None:
            row["library_note"] = ("no single PyTorch call computes "
                                   "exp(v - out[row]) * g[row] per entry")
        else:
            try:
                row["library_ms"] = time_ms(lib, reps=reps)
            except (RuntimeError, NotImplementedError) as exc:
                row["library_error"] = str(exc).splitlines()[0][:200]
        if name == "lse_rows":
            row["library_note"] = ("torch.sparse.log_softmax, dim 1: the "
                                   "same row reduction over the stored "
                                   "entries, as include_zeros=False")
        if name == "dia_spmm":
            row["per_launch"] = k1
        rows.append(row)
    rows.append(k13_row)
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = k1_compare() if sys.argv[1:] == ["--k1"] else main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
