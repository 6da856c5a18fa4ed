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
   (``k1_windows``); K2 (the DIA SDDMM) at p = 128, 16, 2 and 1 on the
   stencil, at p = 128 and 2 on the tri-stencil's 13 offsets and on K1's
   awkward set with X, then Y, unaligned, each launch twice and bitwise
   equal, after printing its window tables (``k2_windows``); the chunk
   kernels on a uniform random pattern of
   cfd2 size (3,087,898 entries; SpMM and SDDMM at p = 128, SpMV at
   p = 1, the SpMM and the SpMV over the transpose plan too; the SpMV,
   K8, also on lse-skewed's rows and its hubs alone, on the hybrid85
   residual's plan and on the small pattern below, over each plan's
   cached row packs and over a table built from indptr, bitwise equal,
   against its plain version in float64; the SpMM, K6, also at
   p = 64, 32, 16 and 130, with B and X unaligned, and on the hybrid85
   residual's plan; the SDDMM, K7, also at p = 64, 32, 16, 3 and 130,
   with X, Y and both unaligned, and on the residual's plan), each run
   twice and bitwise equal, and at a small size with empty rows, a row
   of 5,000 entries, p = 3 and n != m;
3. runs ``sparse_mm`` forward and backward through the public entry
   point on that stencil, on a hybrid pattern at 85 % DIA coverage, at
   p = 16, and on the random pattern at p = 128 and p = 1, and public
   ``sddmm`` on the random pattern and on the stencil; checks outputs and
   gradients against the generic ``backend="xla"`` path on the card and
   a small case against a dense product, and checks that each kernel of
   each path launched during its run (counters set to 0 just before,
   read just after; K1's, K2's, K6's, K7's, K8's and K13's plain
   versions must not run on a path that launches their kernel, and K8
   must launch twice in the random p = 1 step);
   ``sparse_triangular_solve`` forward and backward on two patterns:
   *tri-stencil*, the stencil's lower triangle (13 offsets, diagonally
   dominant) at p = 128 and p = 2, its upper mirror and its transposed
   solve, on the banded kernel; *tri-random*, a random lower factor of
   1,543,949 entries at p = 2, on the route ``auto`` picks.  It checks the
   relative residual ``|A x - B| / |B|`` through ``sparse_mm``, the
   gradients against another algorithm on the card, a small case against
   a dense solve, and the launch counters (the banded route must launch
   the triangular kernel and its block inverses, and run neither's plain
   version; both kernels also against their plain versions at the cfd2
   shapes and small awkward ones in phase 2, three dtypes, bitwise
   repeats);
   ``sparse_logsumexp`` (dim 1, dim 0) and ``sparse_bidir_logsumexp``
   forward and backward on three patterns: *lse-stencil* (the DIA route),
   *lse-random* (the row-ELL grid both ways) and *lse-skewed* (1,235 hub
   rows of 1,250 entries and uniform rest, 3,087,898 entries: the chunk
   LSE kernels on rows, the ELL grid on columns), against the segment
   path on the card, with per-route launch checks (the chunk LSE kernels
   launch on lse-skewed only); and *random-fused*, ``sparse_mm`` on the
   random pattern at p = 128 with ``SPMM_BWD = "fused"`` (and
   ``grad_precision="fast"``), against the split backward, one launch
   of K12 a backward and no plain version, with each backward's peak
   memory (the LSE and
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
   then (3e, ``phase_solvers``) ``sparse_generic_solve`` and
   ``sparse_generic_lstsq`` over the Krylov solvers in float32: CG,
   MINRES and BiCGSTAB on an SPD stencil of the cfd2 shape (25
   diagonals, 3,056,188 entries: K1, K2 and K3), CG at 8 right-hand
   sides, CG and MINRES on a random SPD matrix of 65,536 rows (K8, K7),
   the default LSMR on a tall random matrix (131,072 x 65,536, 1,048,576
   entries, every column filled), each forward and forward+backward of
   ``(x**2).sum()``: the matvec kernel must launch once per matvec and
   no plain version at all, the relative residual (<= 1e-4) and
   ``Aᵀ gradB`` against the cotangent (<= 1e-4) in float64, gradA
   against the plain SDDMM in float64, no more host reads than one
   every ``CHECK_EVERY`` iterations and one at the end; each solve's
   iterations, wall, event and profiled device ms, busy share, host
   reads and every host sync by its line, as a ``solvers`` JSON line;
   then (3f, ``phase_models``) ``SparseMultivariateNormal`` at the
   flagship's width in float32: the ``PairwiseEncoder(1.5, (1, 48, 48,
   48))`` factor (110,592 rows, 961,056 strictly lower entries, the
   diagonal stored too for the LLᵀ forms), S = 128; for each of the
   four parameterisations ``rsample`` forward and forward+backward of
   ``(x**2).sum()`` and ``log_prob`` forward and forward+backward: the
   launch counts (K1 in the covariance samples, K9 in the precision
   samples and the covariance ``log_prob``, K2 in their backwards, K3;
   no plain version), outputs and the gradients of ``loc``,
   ``diagonal`` and the factor's values against the same calls with
   every kernel on its plain version on the card, the precision forms'
   solve residual (<= 1e-5) through ``sparse_mm``, then the times; and
   five Adam steps of a GMRF fit through the example's ``step``
   (``torchsparsegradutils_tpu_torch/examples/fit_sparse_gmrf.py``; the
   loss must fall); one ``models`` JSON line; then (3g,
   ``phase_interop``) the ELL engine, distributed solves, interop and
   ``explain``; then (3h, ``phase_dynamic``) device-resident patterns
   (``pattern_static=False``): a kNN pattern of 3,086,000 entries drawn
   on the card each step through ``sparse_mm`` fwd+bwd and ``sddmm``
   with zero host syncs, no plan and no kernel launch, against the same
   pattern static (K6, K7, K3) and beside the static path's host work a
   new pattern; ``tocsr`` of the random pattern shuffled (two K3
   launches, bitwise the static one, zero syncs); both LSE ops; CG in
   float64 on the stencil SPD (the static solve's iterations); the dense
   triangular fallback at n = 4,096 with its warning; one ``dynamic``
   JSON line;
4. times the chained forward and forward+backward steps, profiles
   seven of them, times the triangular solve's host plans, times K1 per
   launch at p = 128, 16 and 1 and for Aᵀ G (``k1_times``: event and
   profiled device time, bound, plain version, ``torch.sparse.mm``) and
   K2 at p = 128, 16, 2 and 1 (``k2_times``, beside
   ``torch.sparse.sampled_addmm``), K6 at p = 128, 64, 32, 16 and 3 on
   the random pattern, for Aᵀ G and on the hybrid85 residual (``k6_times``,
   beside ``torch.sparse.mm``, with a probe of B's read rows folded into
   15.8 MB), K7 at p = 128, 64, 32, 16, 8, 3, 2 and 1 and on the residual
   (``k7_times``, beside ``torch.sparse.sampled_addmm``, with the same
   probe, K12's device time and the slab probe), K9 at p = 128 and 2
   and for the backward's transposed solve (``k9_times``: event and
   profiled device time, the block inverses alone, bound, plain version,
   ``torch.triangular_solve``), K8 for A x and Aᵀ g on the random
   pattern, on lse-skewed's rows (whole, hubs, light rows) and on the
   residual (``k8_times``, beside the profiled device time of
   ``torch.mv`` and ``torch.sparse.mm``), and
   times each kernel, its plain version and one PyTorch library call that
   computes the same function, with CUDA events, and prints them as a
   ``{"kernels": [...]}`` line (twelve rows, K13's from phase 3d, K1's,
   K2's, K6's, K7's, K8's and K9's with ``per_launch``, K3's and K8's
   with their and the library call's profiled device time, K12's and
   K9's block inverses' with their own; K12's with gradA's and gradB's
   library calls, ``torch.sparse.sampled_addmm`` and ``torch.sparse.mm``
   on Aᵀ, each alone and both in turn, as no one call gives both);
5. prints ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device it exits 1 and prints no result.

``python3 chip_smoke.py --solve`` builds the kernels and runs phase 3e
alone, ``--models`` phase 3f, ``--interop`` phase 3g, ``--dynamic``
phase 3h.  ``python3 chip_smoke.py --k1`` prints only K1's ``k1_times`` and the
times of the steps that launch it (stencil, hybrid85, stencil p=16,
sharded-dia fwd+bwd; wall and profiled device time) as one
``k1_compare`` line; ``--k2`` prints K2's ``k2_times`` and the same
steps with tri-stencil p = 2 fwd+bwd as one ``k2_compare`` line;
``--k6`` prints K6's ``k6_times``, K13's time whole and per slab of 4,
and the steps that launch K6 or K13 (random p=128, hybrid85,
sharded-chunk at world size 1, public ``sddmm`` on the random pattern)
as one ``k6_compare`` line; ``--k7`` prints K7's ``k7_times`` and the
same steps with random p=1, tri-random p=2 and random-fused (whose K12
computes K7's gradA; random and random-fused with one step's peak
memory too) as one ``k7_compare`` line; ``--k8`` prints K8's
``k8_times`` (with the gather probe and K8 at each fixed lane group)
and the random p = 1 fwd+bwd step that launches it, with, for control,
stencil and random ``sparse_mm`` fwd+bwd at p = 128, which do not, as
one ``k8_compare`` line; ``--k9`` prints K9's
``k9_times`` and the steps that launch it (tri-stencil p = 128 and 2,
fwd and fwd+bwd, the upper mirror and the transposed solve, and the
fwd+bwd peak extra memory) with, for control, steps that do not
(stencil, hybrid85, random, tri-random p = 2, the bidir LSE on
lse-random and lse-skewed, sharded-chunk, sharded-dia, the flagship
train step) as one ``k9_compare`` line; ``--k10`` prints K10's and
K11's ``k10_times`` (per launch on lse-skewed's rows and the random
pattern's, both ``include_zeros``, with K10/K11 on the skewed hubs and
light rows apart) and the
lse-skewed steps that launch them with, for control, four that do not
(lse-random and lse-stencil bidir fwd+bwd, stencil and random
``sparse_mm`` fwd+bwd) as one ``k10_compare`` line.  Copied into an
unpacked checkout of another commit (``git archive``) and run from
there, each measures that commit's kernel the same way, so two commits
compare on one card in turns.  ``--k9`` and ``--k10`` also count their
kernels' launches in one call of each step (``<step>_k9_launches``,
``<step>_k10_launches``, ``<step>_k11_launches``), so the control steps
show that they launch none; so does ``--k8`` (``<step>_k8_launches``).
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
TRI_KERNELS = ("tri_dia", "tri_dia_inv", "dia_sddmm", "gather")
TRI_RANDOM_KERNELS = ("chunk_sddmm", "gather")
LSE_CHUNK = ("lse_rows", "lse_rows_bwd")
FUSED = ("chunk_bwd_cols", "gather")  # K12 between two K3 gathers
GRAD_TOL = (1e-4, 1e-6)  # (rtol, atol): LSE gradients, the JAX tests' own
FAST_REL = 1e-2  # |gradB - split| / |split|, K12's products in bfloat16
ROUTES = []             # triangular-solve routes taken, in order
PLAIN = {"dia_spmm_plain": 0,    # K1's, K2's, K3's, K6's, K7's, K8's,
         "dia_sddmm_plain": 0,   # K9's, K12's and K13's plain versions
         "chunk_spmm_plain": 0,  # called by their wrappers
         "chunk_spmm_slab_plain": 0, "chunk_sddmm_plain": 0,
         "chunk_spmv_plain": 0, "tri_dia_plain": 0, "gather_plain": 0,
         "chunk_bwd_cols_plain": 0}
K1_PS = (128, 16, 1)    # K1's widths on the main path: stencil, p=16, matvec
K2_PS = (128, 16, 2, 1)  # K2's: stencil, p=16, tri-stencil p=2, matvec
K6_PS = (128, 64, 32, 16, 3)  # K6's widths timed on the random pattern
K7_PS = (128, 64, 32, 16, 8, 3, 2, 1)  # K7's: its slab, narrow and p=1 paths
K9_PS = (128, 2)        # K9's widths on the main path: tri-stencil


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
        chunk_bwd_cols, chunk_sddmm, chunk_spmm, chunk_spmm_slab,
        chunk_spmv)
    from torchsparsegradutils_tpu_torch.kernels.dia import (sddmm_core,
                                                            spmm_core)
    from torchsparsegradutils_tpu_torch.kernels.dia_tri import (
        tri_dia_core, tri_dia_inv)
    from torchsparsegradutils_tpu_torch.kernels.window_gather import (
        window_gather)
    return {"dia_spmm": spmm_core, "dia_sddmm": sddmm_core,
            "gather": window_gather, "chunk_spmm": chunk_spmm,
            "chunk_sddmm": chunk_sddmm, "chunk_spmv": chunk_spmv,
            "tri_dia": tri_dia_core, "tri_dia_inv": tri_dia_inv,
            "lse_rows": lse_rows,
            "lse_rows_bwd": lse_rows_bwd, "chunk_bwd_cols": chunk_bwd_cols,
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


def count_plain():
    """Count calls of K1's, K2's, K3's, K6's, K7's, K8's, K9's (the solve's
    and the block inverses'), K12's and K13's plain versions made through their
    kernels modules (their wrappers' CPU paths) in ``PLAIN``: a step on
    the card must make none."""
    from torchsparsegradutils_tpu_torch.kernels import chunk_spmm, dia, dia_tri
    from torchsparsegradutils_tpu_torch.kernels import window_gather as wg
    for mod, key, name in ((wg, "gather_plain", "window_gather_plain"),
                           (dia_tri, "tri_dia_plain", "tri_dia_core_plain"),
                           (dia_tri, "tri_dia_plain", "_build_diag_inv"),
                           (dia, "dia_spmm_plain", "spmm_core_plain"),
                           (dia, "dia_sddmm_plain", "sddmm_core_plain"),
                           (chunk_spmm, "chunk_spmm_plain",
                            "chunk_spmm_plain"),
                           (chunk_spmm, "chunk_spmm_slab_plain",
                            "chunk_spmm_slab_plain"),
                           (chunk_spmm, "chunk_sddmm_plain",
                            "chunk_sddmm_plain"),
                           (chunk_spmm, "chunk_spmv_plain",
                            "chunk_spmv_plain"),
                           (chunk_spmm, "chunk_bwd_cols_plain",
                            "chunk_bwd_cols_plain")):
        plain = getattr(mod, name)

        def counted(*a, _plain=plain, _key=key, **k):
            PLAIN[_key] += 1
            return _plain(*a, **k)
        setattr(mod, name, counted)


def zero_counters():
    for fn in counters().values():
        fn.launches = 0
    for key in PLAIN:
        PLAIN[key] = 0


def read_counters(label, expect, forbid=()):
    """Launch counts since :func:`zero_counters`; raises if a kernel of
    ``expect`` did not launch or one of ``forbid`` did."""
    import torch
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    launches.update(PLAIN)
    print(f"  {label}: launches {launches}")
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} never launched")
    forbid = tuple(forbid) + tuple(f"{k}_plain" for k in ("dia_spmm",
                                                          "dia_sddmm",
                                                          "tri_dia")
                                   if k in expect)
    if {"chunk_spmm", "chunk_spmm_slab"} & set(expect):
        forbid += ("chunk_spmm_plain", "chunk_spmm_slab_plain")
    if "chunk_sddmm" in expect:
        forbid += ("chunk_sddmm_plain",)
    if "chunk_spmv" in expect:
        forbid += ("chunk_spmv_plain",)
    if "chunk_bwd_cols" in expect:
        forbid += ("chunk_bwd_cols_plain",)
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


def k2_repeat_close(label, offs, X, Y, geo, dt_name):
    """K2 on (offs, X, Y) twice (bitwise equal), against its plain
    version; returns the max abs error."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.dia import (sddmm_core,
                                                            sddmm_core_plain)
    got = sddmm_core(offs, X, Y, geo)
    if not torch.equal(got, sddmm_core(offs, X, Y, geo)):
        raise AssertionError(f"dia_sddmm {label} [{dt_name}]: two launches "
                             "differ")
    return close(f"dia_sddmm {label} (repeats bitwise)", got,
                 sddmm_core_plain(offs, X, Y), dt_name)


def unaligned(t, lead, gen):
    """``t`` as a contiguous view ``lead`` elements into a larger storage
    (not 16-byte aligned for ``lead`` > 0)."""
    import torch
    if not lead:
        return t
    buf = torch.randn(lead + t.numel(), generator=gen).to(t.device, t.dtype)
    v = buf[lead:].view(t.shape).copy_(t)
    if v.data_ptr() % 16 == 0:
        raise AssertionError("unaligned operand: the view is aligned")
    return v


def check_k2(A, plan, tplan, B, G, gen, dev):
    """K2 against its plain version in three dtypes, each launch twice
    and bitwise equal: at the cfd2 stencil at each p of ``K2_PS`` (X = G,
    Y = B, the stencil step's gradA), the tri-stencil's 13 offsets at
    p = 128 and 2, and :func:`k1_awkward`'s set with X, then Y, unaligned
    where the set passes an unaligned operand.  Prints K2's window tables
    at its p = 128, 16 and 1 tiles; returns the max f32 error."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.dia import sddmm_tile
    geo, tgeo = plan.geo, tplan.geo
    tables = {}
    for p in (128, 16, 1):
        b = B[:, :p].contiguous()
        name, rows, _, cap, count, seg = sddmm_tile(b, b)
        tables[f"p{p}"] = {
            "tile": name, "rows_per_tile": rows, "cap": cap,
            "max_runs": count, "seg": seg,
            "stencil": geo.windows(rows, cap, count, seg).tolist(),
            "tri_stencil": tgeo.windows(rows, cap, count, seg).tolist()}
    print(json.dumps({"k2_windows": tables}))
    err = 0.0
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        name = str(dt).removeprefix("torch.")
        for p in K2_PS:
            x, y = (t[:, :p].contiguous().to(dt) for t in (G, B))
            e = k2_repeat_close(f"cfd2 stencil p={p}", geo.offsets_on(dev),
                                x, y, geo, name)
            if dt == torch.float32:
                err = max(err, e)
        for p in (128, 2):
            x, y = (t[:, :p].contiguous().to(dt) for t in (G, B))
            k2_repeat_close(f"tri-stencil p={p}", tgeo.offsets_on(dev), x, y,
                            tgeo, name)
        for label, ag, p, lead in k1_awkward(A):
            x = torch.randn(ag.n, p, generator=gen).to(dev, dt)
            y = torch.randn(ag.m, p, generator=gen).to(dev, dt)
            turns = ([(x, y, "")] if not lead else
                     [(unaligned(x, lead, gen), y, " (X unaligned)"),
                      (x, unaligned(y, lead, gen), " (Y unaligned)")])
            for xa, ya, what in turns:
                k2_repeat_close(label + what, ag.offsets_on(dev), xa, ya, ag,
                                name)
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
    """K6 (A@B and Aᵀ X) and K7 against their plain versions, each
    launched twice and bitwise equal; returns the largest errors (K8:
    :func:`check_k8`)."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_sddmm, chunk_sddmm_plain, chunk_spmm, chunk_spmm_plain)
    d, dt = plan.maps(B.device), plan.T.maps(B.device)
    vals_t = plan.to_T(vals)
    checks = [
        ("chunk_spmm", "A@B", chunk_spmm, chunk_spmm_plain,
         (d["indptr"], d["cols"], vals, B)),
        ("chunk_spmm", "A^T X", chunk_spmm, chunk_spmm_plain,
         (dt["indptr"], dt["cols"], vals_t, X)),
        ("chunk_sddmm", "X, B", chunk_sddmm, chunk_sddmm_plain,
         (d["indptr"], d["cols"], X, B))]
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


def check_k6_cases(plan, rplan, vals, rvals, B, X, dt_name, gen):
    """K6 (A @ B and Aᵀ X) against its plain version beyond
    :func:`check_chunk_kernels`'s p = 128, each launched twice and bitwise
    equal: at p = 64, 32, 16 and 130 (past a slab and a 128-column tile),
    with B, then X, unaligned at p = 128, and on the hybrid85 residual's
    plan (``rplan``, values ``rvals``) at p = 128.  Returns the largest
    error."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_spmm, chunk_spmm_plain)
    cases = [(f"p={p}", plan, vals, B[:, :p].contiguous(),
              X[:, :p].contiguous()) for p in (64, 32, 16)]
    wide = torch.cat([B, B[:, :2]], 1), torch.cat([X, X[:, :2]], 1)
    cases += [("p=130", plan, vals, *wide),
              ("B, X unaligned", plan, vals, unaligned(B, 1, gen),
               unaligned(X, 1, gen)),
              ("hybrid85 residual", rplan, rvals, B, X)]
    err = 0.0
    for what, pl, v, b, x in cases:
        d, dt = pl.maps(b.device), pl.T.maps(b.device)
        for side, args in (("A@B", (d["indptr"], d["cols"], v, b)),
                           ("A^T X", (dt["indptr"], dt["cols"],
                                      pl.to_T(v), x))):
            got, again = chunk_spmm(*args), chunk_spmm(*args)
            if not torch.equal(got, again):
                raise AssertionError(f"chunk_spmm {what} {side} "
                                     f"[{dt_name}]: two launches differ")
            err = max(err, close(f"chunk_spmm {what} {side} (repeats "
                                 "bitwise)", got, chunk_spmm_plain(*args),
                                 dt_name))
    return err


def check_k7_cases(plan, rplan, Y, X, dt_name, gen):
    """K7 against its plain version beyond :func:`check_chunk_kernels`'s
    p = 128, each launched twice and bitwise equal: at p = 64, 32, 16, 3
    and 130 (past a slab and a 128-column tile), with X, then Y, then
    both unaligned at p = 128, and on the hybrid85 residual's plan
    (``rplan``, whose rows hold fewer than 8 entries on average) at
    p = 128.  Returns the largest error."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_sddmm, chunk_sddmm_plain)
    cases = [(f"p={p}", plan, X[:, :p].contiguous(), Y[:, :p].contiguous())
             for p in (64, 32, 16, 3)]
    cases += [("p=130", plan, torch.cat([X, X[:, :2]], 1),
               torch.cat([Y, Y[:, :2]], 1)),
              ("X unaligned", plan, unaligned(X, 1, gen), Y),
              ("Y unaligned", plan, X, unaligned(Y, 1, gen)),
              ("X, Y unaligned", plan, unaligned(X, 1, gen),
               unaligned(Y, 1, gen)),
              ("hybrid85 residual", rplan, X, Y)]
    err = 0.0
    for what, pl, x, y in cases:
        d = pl.maps(y.device)
        args = (d["indptr"], d["cols"], x, y)
        got, again = chunk_sddmm(*args), chunk_sddmm(*args)
        if not torch.equal(got, again):
            raise AssertionError(f"chunk_sddmm {what} [{dt_name}]: two "
                                 "launches differ")
        err = max(err, close(f"chunk_sddmm {what} (repeats bitwise)", got,
                             chunk_sddmm_plain(*args), dt_name))
    return err


def sub_rows(plan, keep, vals, dev):
    """The rows ``keep`` (a mask over a chunk plan's rows) as a CSR of
    their own: (indptr, cols, their values) on ``dev`` and the host
    indptr."""
    import numpy as np
    import torch
    lens = np.diff(plan.indptr)
    indptr = np.concatenate([[0], np.cumsum(lens[keep])])
    sel = torch.from_numpy(np.flatnonzero(np.repeat(keep, lens))).to(dev)
    return (torch.from_numpy(indptr).to(dev), plan.maps(dev)["cols"][sel],
            vals[sel], indptr)


def k8_table(indptr, dev):
    """K8's pack table of a host ``indptr`` (cut at ``SPMV_PACK``), or
    None in a checkout whose K8 takes none."""
    from torchsparsegradutils_tpu_torch.kernels import chunk_lse, chunk_spmm
    T = getattr(chunk_spmm, "SPMV_PACK", None)
    return None if T is None else chunk_lse.pack_table(indptr, dev, T)


def k8_calls(plan, vals, x, g):
    """K8's two calls on a chunk plan: ``A x`` over the plan and ``Aᵀ g``
    over its transpose plan (the values reordered by K3), each as
    ``(indptr, cols, values, x)`` and the plan's cached pack table (None
    in a checkout whose K8 takes none)."""
    from torchsparsegradutils_tpu_torch.kernels import chunk_lse, chunk_spmm
    T = getattr(chunk_spmm, "SPMV_PACK", None)
    dev = x.device
    d, dt = plan.maps(dev), plan.T.maps(dev)
    return {"A@x": ((d["indptr"], d["cols"], vals, x),
                    T and chunk_lse.plan_packs(plan, dev, T)),
            "A^T g": ((dt["indptr"], dt["cols"], plan.to_T(vals), g),
                      T and chunk_lse.plan_packs(plan.T, dev, T))}


def check_k8(label, calls, dt_name):
    """K8 against its plain version on each of ``calls`` (as
    :func:`k8_calls` gives them), launched twice over the call's pack
    table and once over a table built from ``indptr``, all three bitwise
    equal; returns the largest error.  The plain version runs in float64
    on the same values, as a float32 index_add sums in an order that
    changes from run to run."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_spmv, chunk_spmv_plain)
    err = 0.0
    for what, (args, pk) in calls.items():
        got, again, built = (chunk_spmv(*args, p) for p in (pk, pk, None))
        if not (torch.equal(got, again) and torch.equal(got, built)):
            raise AssertionError(f"{label} chunk_spmv {what} [{dt_name}]: "
                                 "two launches differ")
        ip, cols, v, x = args
        err = max(err, close(
            f"{label} chunk_spmv {what} (repeats bitwise)", got,
            chunk_spmv_plain(ip, cols, v.double(), x.double()), dt_name))
    return err


def check_tri_small(dt, name, gen, dev):
    """The triangular kernel on small awkward shapes, each launch twice
    and bitwise equal, against its plain version at the kernel's row block
    nb: n not a multiple of 256, p = 1 and 3, unit, positive offsets
    (ignored), the span at a block boundary, 200 offsets; and the block
    walk's edges: n = 3 nb - 1, 3 nb and 3 nb + 1, span nb and nb + 1
    (in the block or the one before) and 2 nb + 1 (the boundary between
    late and early terms), offsets -(nb - 1) and -nb, p = TP - 1, TP,
    TP + 1 and 2 TP + 1, unit with no offset 0, a band of 8,000 (too wide
    in float64 for the walk's shared-memory ring and grid rows).  The
    block inverses against ``_build_diag_inv`` on each."""
    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch.kernels import dia_tri
    nb, tp = dia_tri.KERNEL_NB, 2       # the walk's row block, column tile
    acc = torch.float64 if dt == torch.float64 else torch.float32
    for n, p, offs, unit in (
            (300, 1, [-130, -17, -3, 0], False),
            (500, 3, [-256, -1, 0, 5], False),
            (777, 5, [-300, -2, -1, 7], True),
            (1000, 2, list(range(-200, 1)), False),
            (3 * nb - 1, tp - 1, [-nb, -(nb - 1), -2, -1, 0], False),
            (3 * nb, tp, [-(nb + 1), -nb, -1, 0], False),
            (3 * nb + 1, tp + 1, [-(nb + 1), -(nb - 1), -3, 0, 2], False),
            (5 * nb + 1, tp, [-nb, -7, -1], True),
            (4 * nb, 2 * tp + 1,
             [-(2 * nb + 1), -2 * nb, -(2 * nb - 1), -(nb + 1), -1, 0],
             False),
            (9000, 3, [-8000, -4000, -1, 0], False)):
        g = torch.randn(n, len(offs), generator=gen) * 0.1
        if 0 in offs:
            k0 = offs.index(0)
            g[:, k0] = 1 + g.abs().sum(1) - g[:, k0].abs()
        g = g.to(dev, dt)
        b = torch.randn(n, p, generator=gen).to(dev, dt)
        o = np.array(offs)
        label = f"n={n} p={p} K={len(offs)} unit={unit} nb={nb}"
        got = dia_tri.tri_dia_core(o, g, b, unit=unit)
        if not torch.equal(got, dia_tri.tri_dia_core(o, g, b, unit=unit)):
            raise AssertionError(f"tri_dia small {label} [{name}]: two "
                                 "launches differ")
        close(f"tri_dia small {label} (repeats bitwise)", got,
              dia_tri.tri_dia_core_plain(o, g, b, unit=unit, nb=nb), name)
        inv = dia_tri.tri_dia_inv(o, g, unit=unit)
        if not torch.equal(inv, dia_tri.tri_dia_inv(o, g, unit=unit)):
            raise AssertionError(f"tri_dia_inv small {label} [{name}]: two "
                                 "launches differ")
        close(f"tri_dia_inv small {label} (repeats bitwise)", inv,
              dia_tri._build_diag_inv(o, g, n, -(-n // nb), nb, unit, acc),
              name)


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
    1,025 entries (packs of their own, walked by the whole block), one
    of 100,000; and its values with +inf, -inf and an all -inf row."""
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
    each launched twice over the plan's cached pack table and bitwise
    equal, and once over a table built from ``indptr``; returns the
    largest errors.  The plain versions run in float64 on the same
    values: a float32 index_add over a 100,000-entry row is itself off
    by about 1e-5 relative, in an order that changes from run to run."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels import _build
    from torchsparsegradutils_tpu_torch.kernels.chunk_lse import (
        lse_rows, lse_rows_bwd, lse_rows_bwd_plain, lse_rows_plain,
        plan_packs)
    ip = plan.maps(vals.device)["indptr"]
    pk = plan_packs(plan, vals.device)
    g = torch.randn(plan.n, generator=gen).to(
        vals.device, _build.acc_dtype(vals.dtype))
    err = {}
    for iz in (False, True):
        out, again = (lse_rows(ip, vals, width, iz, pk) for _ in range(2))
        if not (torch.equal(out, again)
                and torch.equal(out, lse_rows(ip, vals, width, iz))):
            raise AssertionError(f"{label} lse_rows [{dt_name}]: two "
                                 "launches differ")
        ref = lse_rows_plain(ip, vals.double(), width, iz)
        e = close_inf(f"{label} lse_rows include_zeros={iz} (repeats "
                      "bitwise)", out, ref, dt_name)
        err["lse_rows"] = max(err.get("lse_rows", 0.0), e)
        d, d2 = (lse_rows_bwd(ip, vals, out, g, pk) for _ in range(2))
        if not (torch.equal(d, d2)
                and torch.equal(d, lse_rows_bwd(ip, vals, out, g))):
            raise AssertionError(f"{label} lse_rows_bwd [{dt_name}]: two "
                                 "launches differ")
        e = close(f"{label} lse_rows_bwd include_zeros={iz} (repeats "
                  "bitwise)", d, lse_rows_bwd_plain(
                      ip, vals.double(), out.double(), g.double()), dt_name)
        err["lse_rows_bwd"] = max(err.get("lse_rows_bwd", 0.0), e)
    return err


def check_fused_kernels(label, plan, vals, B, G, dt_name):
    """K12 against its plain version, exact and with its products rounded
    to bfloat16, each launched twice and bitwise equal; gradA bitwise
    K7's; returns the largest error."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        chunk_bwd_cols, chunk_bwd_cols_plain, chunk_sddmm)
    d, dt = plan.maps(B.device), plan.T.maps(B.device)
    args = (dt["indptr"], dt["cols"], dt["perm"], dt["inv"], vals, B, G)
    err = 0.0
    for fast in (False, True):
        (dd, dB), (dd2, dB2) = (chunk_bwd_cols(*args, fast)
                                for _ in range(2))
        if not (torch.equal(dd, dd2) and torch.equal(dB, dB2)):
            raise AssertionError(f"{label} chunk_bwd_cols [{dt_name}] fast="
                                 f"{fast}: two launches differ")
        if not torch.equal(dd, chunk_sddmm(d["indptr"], d["cols"], G, B)):
            raise AssertionError(f"{label} chunk_bwd_cols [{dt_name}] fast="
                                 f"{fast}: dd is not K7's")
        pdd, pdB = chunk_bwd_cols_plain(*args, fast)
        err = max(err,
                  close(f"{label} chunk_bwd_cols dd fast={fast} (repeats "
                        "bitwise, K7's bitwise)", dd, pdd, dt_name),
                  close(f"{label} chunk_bwd_cols dB fast={fast} (repeats "
                        "bitwise)", dB, pdB, dt_name))
        del pdd, pdB
    return {"chunk_bwd_cols": err}


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


def lse_step(A, what):
    """A step of the LSE ops on A on ``auto``: ``dim1_fwd``, ``dim0_fwd``,
    ``bidir_fwd`` (no graph) or ``bidir_fwd_bwd`` (the bidir LSE and the
    gradient of its outputs' weighted sum)."""
    import torch
    from torchsparsegradutils_tpu_torch import (sparse_bidir_logsumexp,
                                                sparse_logsumexp)
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


def peak_extra(fn):
    """fn()'s result and the MiB it allocated above what was held before,
    at its peak."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = fn()
    torch.cuda.synchronize()
    return res, (torch.cuda.max_memory_allocated() - base) / 2**20


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


def k2_times(A, plan, B, G, dev):
    """K2's time per launch (CUDA events, and the kernel's profiled device
    time) at each p of ``K2_PS`` (X = G, Y = B), each beside its bound,
    its plain version and ``torch.sparse.sampled_addmm`` on A's CSR, which
    computes the same values at the same entries."""
    import inspect

    import torch
    from torchsparsegradutils_tpu_torch.kernels.dia import (sddmm_core,
                                                            sddmm_core_plain)
    # a checkout from before K2's window table passes no geometry
    with_geo = "geo" in inspect.signature(sddmm_core).parameters
    kw = {"geo": plan.geo} if with_geo else {}
    n, m, K = A.shape[0], A.shape[1], plan.K
    cells = valid_cells(plan.offsets.tolist(), n, m)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr_np().astype("int64")).to(dev),
        A.cols_t(), A.values, (n, m))
    offs = plan.geo.offsets_on(dev)
    out = {}
    for p in K2_PS:
        X, Y = G[:, :p].contiguous(), B[:, :p].contiguous()
        b_ms, b_by = bound((n * p + m * p + n * K) * 4 + K * 8,
                           2 * cells * p)
        out[f"p{p}"] = {
            "ms": time_ms(lambda: sddmm_core(offs, X, Y, **kw)),
            "device_ms": device_ms(lambda: sddmm_core(offs, X, Y, **kw),
                                   "dia_sddmm_kernel"),
            "plain_ms": time_ms(lambda: sddmm_core_plain(offs, X, Y),
                                reps=5),
            "library_ms": time_ms(lambda: torch.sparse.sampled_addmm(
                csr, X, Y.t(), beta=0.0)),
            "bound_ms": b_ms, "bound_by": b_by}
    return out


def k6_times(R, cplan, H, B, G, dev):
    """K6's time per launch (CUDA events, and the kernel's profiled device
    time) for A @ B on the random pattern at each p of ``K6_PS`` (p = 3
    on the scalar path), for
    Aᵀ G over ``plan.T`` and on the hybrid85 residual at p = 128, each
    beside its bound, its plain version and ``torch.sparse.mm`` on the
    same CSR; as a probe of the L2, A @ B at p = 128 with every column
    folded into B's first N / 4 rows (15.8 MB of B read, which the L2
    holds; no plain or library time, as rows may repeat a column); and,
    where the checkout picks K6's column slab on the host
    (``slab_bytes``), the profiled device time of A @ B at p = 128 on the
    random pattern and on the residual with slabs of one, two and four
    128-byte lines (``slab_probe``)."""
    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch.kernels import chunk_spmm as cs
    from torchsparsegradutils_tpu_torch.kernels import dia
    chunk_spmm, chunk_spmm_plain = cs.chunk_spmm, cs.chunk_spmm_plain
    es = 4
    hplan = dia.build_dia_plan(H.row_sa(), H.col_sa(), N, N)
    rp = dia._resid_chunk_plan(hplan)
    hv = H.values[torch.from_numpy(hplan.resid_sel).to(dev)]
    d, dt, dr = cplan.maps(dev), cplan.T.maps(dev), rp.maps(dev)
    fold = N // 4
    cases = [(f"p{p}", d, d["cols"], R.values, B[:, :p].contiguous(),
              cplan.cols) for p in K6_PS]
    cases += [("transpose_p128", dt, dt["cols"], R.values[dt["perm"]], G,
               cplan.T.cols),
              ("resid_p128", dr, dr["cols"], hv, B, rp.cols),
              ("p128_l2_resident", d, d["cols"] % fold, R.values, B,
               cplan.cols % fold)]
    out = {}
    for label, maps, cols, vals, X, host_cols in cases:
        ip = maps["indptr"]
        n, nnz, p = ip.shape[0] - 1, cols.shape[0], X.shape[1]
        ucols = len(np.unique(host_cols))          # B rows the launch reads
        b_ms, b_by = bound(nnz * (es + 8) + (n + 1) * 8
                           + (ucols + n) * p * es, 2 * nnz * p)
        row = {"entries": nnz, "ms": time_ms(
                   lambda: chunk_spmm(ip, cols, vals, X)),
               "device_ms": device_ms(lambda: chunk_spmm(ip, cols, vals, X),
                                      "chunk_spmm_kernel"),
               "bound_ms": b_ms, "bound_by": b_by}
        if label != "p128_l2_resident":
            csr = torch.sparse_csr_tensor(ip, cols, vals, (n, X.shape[0]))
            row["plain_ms"] = time_ms(
                lambda: chunk_spmm_plain(ip, cols, vals, X), reps=5)
            row["library_ms"] = time_ms(lambda: torch.sparse.mm(csr, X))
        out[label] = row
    if hasattr(cs, "slab_bytes"):
        saved = cs.SLAB_BYTES, cs.SHORT_SLAB_BYTES
        probe = {}
        try:
            for label, maps, cols, vals in (
                    ("random_p128", d, d["cols"], R.values),
                    ("resid_p128", dr, dr["cols"], hv)):
                for slab in (128, 256, 512):
                    cs.SLAB_BYTES = cs.SHORT_SLAB_BYTES = slab
                    probe.setdefault(label, {})[slab] = device_ms(
                        lambda: chunk_spmm(maps["indptr"], cols, vals, B),
                        "chunk_spmm_kernel")
        finally:
            cs.SLAB_BYTES, cs.SHORT_SLAB_BYTES = saved
        out["slab_probe"] = probe
    return out


def k7_times(R, cplan, H, B, G, dev):
    """K7's time per call (CUDA events, and the profiled device time of
    every kernel whose name holds ``chunk_sddmm``, so of all its passes)
    for gradA = sddmm(G, B) on the random pattern at each p of ``K7_PS``,
    and on the hybrid85 residual at p = 128, each beside its bound, its
    plain version and ``torch.sparse.sampled_addmm`` on the same CSR; as a
    probe of the L2, p = 128 with every column folded into B's first
    N / 4 rows (15.8 MB of B read, which the L2 holds; no plain or
    library time, as rows may repeat a column); the fused backward's
    device time at p = 128 (K12a's pass 1 where the checkout has it, else
    K12, whose gradA is K7's, bitwise); and, where the checkout picks
    K7's column slab on the host (``sddmm_passes``), the profiled device
    time at p = 128 on the random pattern and on the residual with slabs
    of one, two and four 128-byte lines (``slab_probe``)."""
    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch.kernels import chunk_spmm as cs
    from torchsparsegradutils_tpu_torch.kernels import dia
    chunk_sddmm, chunk_sddmm_plain = cs.chunk_sddmm, cs.chunk_sddmm_plain
    es = 4
    hplan = dia.build_dia_plan(H.row_sa(), H.col_sa(), N, N)
    rp = dia._resid_chunk_plan(hplan)
    d, dr = cplan.maps(dev), rp.maps(dev)
    fold = N // 4
    cases = [(f"p{p}", d, d["cols"], G[:, :p].contiguous(),
              B[:, :p].contiguous(), cplan) for p in K7_PS]
    cases += [("resid_p128", dr, dr["cols"], G, B, rp),
              ("p128_l2_resident", d, d["cols"] % fold, G, B, cplan)]
    out = {}
    for label, maps, cols, X, Y, pl in cases:
        ip = maps["indptr"]
        n, nnz, p = ip.shape[0] - 1, cols.shape[0], X.shape[1]
        host_cols = pl.cols % fold if label == "p128_l2_resident" \
            else pl.cols
        ucols = len(np.unique(host_cols))           # Y rows the call reads
        urows = int((pl.indptr[1:] > pl.indptr[:-1]).sum())    # X rows
        b_ms, b_by = bound((urows + ucols) * p * es + nnz * 8
                           + (n + 1) * 8 + nnz * es, 2 * nnz * p)
        row = {"entries": nnz,
               "ms": time_ms(lambda: chunk_sddmm(ip, cols, X, Y)),
               "device_ms": device_ms(lambda: chunk_sddmm(ip, cols, X, Y),
                                      "chunk_sddmm"),
               "bound_ms": b_ms, "bound_by": b_by}
        if label != "p128_l2_resident":
            csr = torch.sparse_csr_tensor(ip, cols, torch.ones(
                nnz, device=dev), (n, Y.shape[0]))
            row["plain_ms"] = time_ms(
                lambda: chunk_sddmm_plain(ip, cols, X, Y), reps=5)
            row["library_ms"] = time_ms(
                lambda: torch.sparse.sampled_addmm(csr, X, Y.t(), beta=0.0))
        out[label] = row
    if hasattr(cs, "chunk_bwd_cols"):
        dt = cplan.T.maps(dev)
        out["k12_p128_device_ms"] = device_ms(
            lambda: cs.chunk_bwd_cols(dt["indptr"], dt["cols"], dt["perm"],
                                      dt["inv"], R.values, B, G), "bwd_cols")
    else:
        out["k12a_p128_device_ms"] = device_ms(
            lambda: cs.chunk_bwd_pass1(d["indptr"], d["cols"], R.values, B,
                                       G, torch.float32), "bwd_rows")
    if hasattr(cs, "sddmm_passes"):
        saved = cs.SLAB_BYTES, cs.SHORT_SLAB_BYTES
        probe = {}
        try:
            for label, maps in (("random_p128", d), ("resid_p128", dr)):
                for slab in (128, 256, 512):
                    cs.SLAB_BYTES = cs.SHORT_SLAB_BYTES = slab
                    probe.setdefault(label, {})[slab] = device_ms(
                        lambda: chunk_sddmm(maps["indptr"], maps["cols"], G,
                                            B), "chunk_sddmm")
        finally:
            cs.SLAB_BYTES, cs.SHORT_SLAB_BYTES = saved
        out["slab_probe"] = probe
    return out


def k8_times(R, cplan, S, H, dev, probes=True):
    """K8's time per launch (CUDA events, and the profiled device time of
    ``chunk_spmv_kernel``) for ``A x`` on the random pattern and ``Aᵀ g``
    over its transpose plan, on lse-skewed's rows (whole, the hubs alone
    and the light rows alone) and on the hybrid85 residual, f32, each
    beside its bound and the profiled device time of ``torch.mv`` and of
    ``torch.sparse.mm`` at p = 1 on the same CSR (``library_ms`` the
    latter's event time); where the checkout passes row packs to K8,
    over the plan's cached table.  With ``probes``: as a probe of the
    gather, the random ``A x`` with every column folded into x's first
    4,096 entries (16 KB, which the L1 holds); and, where K8 takes a
    table, the random ``A x`` and ``Aᵀ g`` and the light rows with the
    table's lane-group column forced to each G of 4, 8, 16 and 32 for
    every pack of several rows (``fixed_G``)."""
    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch.kernels import dia
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        build_chunk_plan, chunk_spmv)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(N, generator=gen).to(dev)
    g = torch.randn(N, generator=gen).to(dev)
    splan = build_chunk_plan(S.row_sa(), S.col_sa(), N, N)
    hplan = dia.build_dia_plan(H.row_sa(), H.col_sa(), N, N)
    rp = dia._resid_chunk_plan(hplan)
    hv = H.values[torch.from_numpy(hplan.resid_sel).to(dev)]
    calls = k8_calls(cplan, R.values, x, g)
    # label: (indptr, cols, values, x), host indptr
    cases = {"random_Ax": (calls["A@x"][0], cplan.indptr),
             "random_ATg": (calls["A^T g"][0], cplan.T.indptr)}
    for label, plan, vals in (("skewed", splan, S.values), ("resid", rp, hv)):
        d = plan.maps(dev)
        cases[label] = ((d["indptr"], d["cols"], vals, x), plan.indptr)
    lens = np.diff(splan.indptr)
    for part, keep in (("hubs", lens > 256), ("light", lens <= 256)):
        ip, cols, v, indptr = sub_rows(splan, keep, S.values, dev)
        cases[f"skewed_{part}"] = ((ip, cols, v, x), indptr)
    if probes:
        ip, cols, v, _ = cases["random_Ax"][0]
        cases["random_Ax_x_in_l1"] = ((ip, cols % 4096, v, x),
                                      cplan.indptr)
    out = {}
    for label, (args, indptr) in cases.items():
        ip, cols, v, xx = args
        n, nnz = ip.shape[0] - 1, cols.shape[0]
        pk = k8_table(indptr, dev)
        kw = {} if pk is None else {"packs": pk}

        def run(kw=kw, args=args):
            return chunk_spmv(*args, **kw)
        ucols = 4096 if label.endswith("l1") else len(np.unique(
            cols.cpu().numpy()))                 # x entries the call reads
        b_ms, b_by = bound(nnz * (4 + 8) + (n + 1) * 8 + (ucols + n) * 4,
                           2 * nnz)
        row = {"rows": n, "entries": nnz, "ms": time_ms(run),
               "device_ms": device_ms(run, "chunk_spmv_kernel"),
               "bound_ms": b_ms, "bound_by": b_by}
        if pk is not None:
            row["packs"] = pk.table.shape[0] - 1
        if not label.endswith("l1"):
            csr = torch.sparse_csr_tensor(ip, cols, v, (n, xx.shape[0]))
            for lib, fn in (("mv", lambda: torch.mv(csr, xx)),
                            ("spmm", lambda: torch.sparse.mm(
                                csr, xx[:, None]))):
                try:
                    row[f"library_{lib}_device_ms"] = device_ms(fn, "")
                    if lib == "spmm":
                        row["library_ms"] = time_ms(fn)
                except (RuntimeError, NotImplementedError) as exc:
                    row[f"library_{lib}_error"] = \
                        str(exc).splitlines()[0][:200]
        if probes and pk is not None and label in (
                "random_Ax", "random_ATg", "skewed_light"):
            several = (pk.table[1:, 0] - pk.table[:-1, 0]) > 1
            row["fixed_G"] = {}
            for G in (4, 8, 16, 32):
                tg = pk.table.clone()
                tg[:-1, 2][several] = int(np.log2(G))
                row["fixed_G"][G] = device_ms(
                    lambda tg=tg: chunk_spmv(*args, pk._replace(table=tg)),
                    "chunk_spmv_kernel")
        out[label] = row
    return out


def k13_times(R, plans, B, dev):
    """K13's time per slab of each sharded chunk plan of ``plans`` (CUDA
    events, and the kernel's profiled device time) beside its bound, its
    plain version and ``torch.sparse.mm`` on the slab's CSR."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels import chunk_spmm as cs
    m, es = R.shape[1], 4
    times = {}
    for plan in plans:
        S, rps = plan.n_shards, plan.rows_per_shard
        pd = plan.maps(dev)
        for s in range(S):
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
                "device_ms": device_ms(lambda: cs.chunk_spmm_slab(*args),
                                       "chunk_spmm_slab_kernel"),
                "plain_ms": time_ms(lambda: cs.chunk_spmm_slab_plain(*args)),
                "library_ms": time_ms(lambda: torch.sparse.mm(csr, B)),
                "bound_ms": b_ms, "bound_by": b_by}
    return times


def k9_times(T, tplan, tgrid, TB, G, dev):
    """K9's time per call of ``tri_dia_core`` (CUDA events, and the
    profiled device time of every kernel whose name holds ``tri_dia``:
    the block inverses and the walk, and each alone) on the tri-stencil
    at each p of ``K9_PS`` and for the transposed solve that the backward
    runs at p = 128, each beside its bound, its plain version (at the
    kernel's row block, where the checkout's plain version takes one) and
    ``torch.triangular_solve`` on the CSR (one call; not for the
    transposed solve); and, where the checkout builds the block inverses
    in a kernel of their own, that build alone."""
    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch.kernels import dia_tri
    n, K = tgrid.shape
    offs = np.asarray(tplan.offsets)
    cells = valid_cells(offs.tolist(), n, n)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(T.indptr_np().astype("int64")).to(dev),
        T.cols_t(), T.values, (n, n))
    # the backward's solve, Aᵀ x = G, reduced to the lower core as
    # ops/triangular_solve.py:_tri_dia_forward reduces it
    gt = tplan.geo.shift(tgrid).flip(0, 1).contiguous()
    offs_t = np.sort(-np.asarray(tplan.geo.T.offsets))
    # a checkout from before the block inverses has one row block, NB
    inv = getattr(dia_tri, "tri_dia_inv", None)
    nb = dia_tri.NB if inv is None else dia_tri.KERNEL_NB
    kw = {} if inv is None else {"nb": nb}
    out = {"plain_nb": nb}
    for label, o, g, X in ([(f"p{p}", offs, tgrid, TB[:, :p].contiguous())
                            for p in K9_PS]
                           + [("transpose_p128", offs_t, gt,
                               G.flip(0).contiguous())]):
        p = X.shape[1]
        b_ms, b_by = bound((n * K + 2 * n * p) * 4, 2 * cells * p)

        def call():
            return dia_tri.tri_dia_core(o, g, X, unit=False)
        row = {"ms": time_ms(call, reps=10),
               "device_ms": device_ms(call, "tri_dia", reps=10),
               "walk_device_ms": device_ms(call, "tri_dia_kernel", reps=10),
               "plain_ms": time_ms(
                   lambda: dia_tri.tri_dia_core_plain(o, g, X, unit=False,
                                                      **kw),
                   reps=2, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if inv is not None:
            row["inverse_device_ms"] = device_ms(call, "tri_dia_inv",
                                                 reps=10)
        if not label.startswith("transpose"):
            row["library_ms"] = time_ms(
                lambda: torch.triangular_solve(X, csr, upper=False),
                reps=1, warmup=1)
        out[label] = row
    if inv is not None:
        out["inverse_alone"] = {
            "nb": nb,
            "ms": time_ms(lambda: inv(offs, tgrid, unit=False)),
            "device_ms": device_ms(lambda: inv(offs, tgrid, unit=False),
                                   "tri_dia_inv"),
            "plain_ms": time_ms(lambda: dia_tri._build_diag_inv(
                offs, tgrid, n, -(-n // nb), nb, False, torch.float32),
                reps=5),
            "scratch_mib": -(-n // nb) * nb * nb * 4 / 2**20}
    return out


def k9_steps(A, H, R, T, plan1, B, G, TB, gen, dev, steps):
    """``--k9``'s steps: those that launch K9 (tri-stencil fwd and fwd+bwd
    at p = 128 and 2, its upper mirror and its transposed solve, fwd+bwd
    at p = 128), after recording the tri-stencil p = 128 fwd+bwd step's
    peak extra memory in ``steps``; then those that do not, for control
    (stencil, hybrid85, random, tri-random p = 2, the bidir LSE fwd+bwd
    on lse-random and lse-skewed, sharded-chunk and sharded-dia at world
    size 1, the flagship train step)."""
    import torch
    from torchsparsegradutils_tpu_torch import (sparse_bidir_logsumexp,
                                                sparse_mm,
                                                sparse_triangular_solve)
    from torchsparsegradutils_tpu_torch.parallel import (
        init_params, make_model, make_train_step, sharded_chunk_spmm,
        sharded_dia_spmm)
    from torchsparsegradutils_tpu_torch.utils.random_sparse import (
        rand_sparse_tri, stencil_sparse)

    def tri(M, X, Y, **kw):
        return chained_step(lambda v, b: sparse_triangular_solve(
            M.with_data(v), b, **kw), M.values, X, Y)

    def tri_fwd(M, X, **kw):
        state = {"b": X.clone()}

        def step():
            with torch.no_grad():
                state["b"] = state["b"] + 1e-6 * sparse_triangular_solve(
                    M, state["b"], **kw)
        return step

    def mm(M, p=P):
        return chained_step(lambda v, b: sparse_mm(M.with_data(v), b),
                            M.values, B[:, :p].contiguous(),
                            G[:, :p].contiguous())

    def lse(M):
        v = M.values.detach().clone().requires_grad_(True)

        def step():
            outs = sparse_bidir_logsumexp(M.with_data(v))
            torch.autograd.grad(outs, v, outs)
        return step

    TB2, G2 = TB[:, :2].contiguous(), G[:, :2].contiguous()
    Tu = stencil_sparse((N, N), [-o for o in TRI_OFFSETS],
                        well_conditioned=True, generator=gen, device=dev)
    step = tri(T, TB, G, upper=False)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    for _ in range(3):
        step()
    steps["tri_stencil_fwd_bwd_peak_extra_mib"] = \
        torch.cuda.max_memory_allocated() / 2**20 - base_mib
    todo = [("tri_stencil_p128", step),
            ("tri_stencil_p128_fwd", tri_fwd(T, TB, upper=False)),
            ("tri_stencil_p2", tri(T, TB2, G2, upper=False)),
            ("tri_stencil_p2_fwd", tri_fwd(T, TB2, upper=False)),
            ("tri_stencil_upper_p128", tri(Tu, TB, G, upper=True)),
            ("tri_stencil_transpose_p128", tri(T, TB, G, upper=False,
                                               transpose=True))]
    TR = rand_sparse_tri((N, N), NNZ_TRI_RANDOM, upper=False, layout="csr",
                         generator=gen, device=dev)
    S = lse_skewed(gen, dev)
    f = sharded_dia_spmm(A)
    enc = make_model((1, 48, 48, 48), radius=1.5)
    state = {"p": init_params(enc, torch.Generator().manual_seed(0), dev)}
    x = torch.randn(128, enc.volume_numel, generator=gen)
    x[:, 1:] += 0.5 * x[:, :-1].clone()
    x = x.to(dev)
    train = make_train_step(enc, 1, 1, lr=1e-2)

    def flagship():
        state["p"], _ = train(state["p"], x)
    todo += [("stencil", mm(A)), ("hybrid85", mm(H)), ("random", mm(R)),
             ("tri_random_p2", tri(TR, TB2, G2, upper=False)),
             ("lse_random_bidir", lse(R)), ("lse_skewed_bidir", lse(S)),
             ("sharded_chunk", chained_step(
                 lambda v, b: sharded_chunk_spmm(plan1, v, b), R.values, B,
                 G)),
             ("sharded_dia", chained_step(f, A.values, B, G)),
             ("flagship_train", flagship)]
    return todo


def lse_skewed(gen, dev):
    """The lse-skewed matrix at cfd2 scale (:func:`skewed_pattern`), its
    values drawn from ``gen``."""
    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch import SparseCSR
    rows, cols = skewed_pattern(N)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=N))])
    return SparseCSR(indptr, cols, torch.randn(len(cols), generator=gen),
                     (N, N), device=dev)


def k10_times(splan, svals, cplan, rvals, gen, dev):
    """K10's and K11's time per launch (CUDA events, and the profiled
    device time of ``lse_rows_kernel`` and ``lse_rows_bwd_kernel``) on
    lse-skewed's rows and the random pattern's rows, K10 with
    ``include_zeros`` true and false, each beside its bound; where the
    checkout plans row packs (``chunk_lse.plan_packs``), the launches
    take the plan's cached table; and :func:`k10_split`."""
    import torch
    from torchsparsegradutils_tpu_torch.kernels import chunk_lse
    packs_of = getattr(chunk_lse, "plan_packs", None)
    out = {}
    for label, plan, vals in (("skewed", splan, svals),
                              ("random", cplan, rvals)):
        ip = plan.maps(dev)["indptr"]
        n, nnz, es = plan.n, plan.nnz, vals.element_size()
        g = torch.randn(n, generator=gen).to(dev)
        kw = {} if packs_of is None else {"packs": packs_of(plan, dev)}
        row = {"rows": n, "entries": nnz}
        for iz in (False, True):
            o = chunk_lse.lse_rows(ip, vals, n, iz, **kw)

            def fwd():
                return chunk_lse.lse_rows(ip, vals, n, iz, **kw)

            def bwd():
                return chunk_lse.lse_rows_bwd(ip, vals, o, g, **kw)
            row[f"include_zeros_{iz}"] = {
                "k10_ms": time_ms(fwd), "k10_device_ms": device_ms(
                    fwd, "lse_rows_kernel"),
                "k11_ms": time_ms(bwd), "k11_device_ms": device_ms(
                    bwd, "lse_rows_bwd_kernel")}
        row["k10_bound_ms"] = bound(nnz * es + (n + 1) * 8 + n * es,
                                    2 * nnz)[0]
        row["k11_bound_ms"] = bound(2 * nnz * es + (n + 1) * 8 + 2 * n * es,
                                    2 * nnz)[0]
        if packs_of is not None:
            row["packs"] = kw["packs"].table.shape[0] - 1
        if label == "skewed":
            row["split"] = k10_split(plan, vals, g, dev, packs_of)
        out[label] = row
    return out


def k10_split(plan, vals, g, dev, packs_of):
    """K10's and K11's profiled device time on lse-skewed's rows of more
    than 256 entries alone (the hubs) and on the others alone, each as a
    CSR of its own, to show which rows take the time."""
    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch.kernels import chunk_lse
    lens = np.diff(plan.indptr)
    out = {}
    for part, keep in (("hubs", lens > 256), ("light", lens <= 256)):
        ip, _, v, indptr = sub_rows(plan, keep, vals, dev)
        gp = g[torch.from_numpy(np.flatnonzero(keep)).to(dev)]
        kw = {} if packs_of is None else {
            "packs": chunk_lse.pack_table(indptr, device=dev)}
        o = chunk_lse.lse_rows(ip, v, plan.m, True, **kw)
        out[part] = {
            "rows": int(keep.sum()), "entries": v.shape[0],
            "k10_device_ms": device_ms(
                lambda: chunk_lse.lse_rows(ip, v, plan.m, True, **kw),
                "lse_rows_kernel"),
            "k11_device_ms": device_ms(
                lambda: chunk_lse.lse_rows_bwd(ip, v, o, gp, **kw),
                "lse_rows_bwd_kernel")}
    return out


def k10_steps(A, R, S, B, G):
    """``--k10``'s steps: those that launch K10 or K11 (lse-skewed
    ``dim1_fwd``, ``bidir_fwd`` and ``bidir_fwd_bwd``), then, for
    control, steps that launch neither (the bidir LSE fwd+bwd on
    lse-random and lse-stencil, ``sparse_mm`` fwd+bwd on the stencil and
    the random pattern)."""
    from torchsparsegradutils_tpu_torch import sparse_mm

    def mm(M):
        return chained_step(lambda v, b: sparse_mm(M.with_data(v), b),
                            M.values, B, G)
    return [("lse_skewed_dim1_fwd", lse_step(S, "dim1_fwd")),
            ("lse_skewed_bidir_fwd", lse_step(S, "bidir_fwd")),
            ("lse_skewed_bidir_fwd_bwd", lse_step(S, "bidir_fwd_bwd")),
            ("lse_random_bidir_fwd_bwd", lse_step(R, "bidir_fwd_bwd")),
            ("lse_stencil_bidir_fwd_bwd", lse_step(A, "bidir_fwd_bwd")),
            ("stencil_fwd_bwd", mm(A)), ("random_fwd_bwd", mm(R))]


def k8_steps(A, R, B, G):
    """``--k8``'s steps: the one that launches K8 (random ``sparse_mm``
    fwd+bwd at p = 1: ``A x``, then ``Aᵀ g``), then, for control, two
    that do not (``sparse_mm`` fwd+bwd at p = 128 on the stencil and the
    random pattern)."""
    from torchsparsegradutils_tpu_torch import sparse_mm

    def mm(M, p):
        return chained_step(lambda v, b: sparse_mm(M.with_data(v), b),
                            M.values, B[:, :p].contiguous(),
                            G[:, :p].contiguous())
    return [("random_p1", mm(R, 1)), ("stencil", mm(A, P)),
            ("random", mm(R, P))]


def compare(which) -> int:
    """``--k1`` / ``--k2`` / ``--k6`` / ``--k7`` / ``--k8`` / ``--k9`` /
    ``--k10``: that kernel's times (:func:`k1_times`, :func:`k2_times`,
    :func:`k7_times`, :func:`k8_times`, :func:`k9_times`,
    :func:`k10_times`; for K6
    :func:`k6_times` and K13's :func:`k13_times`, whole and per slab of
    4) and the times of the steps that launch it, wall and profiled
    device time, nothing else:
    for K1 and K2 stencil, hybrid85, stencil p=16 and sharded-dia
    fwd+bwd (K2 also tri-stencil p = 2); for K6 and K7 random p=128,
    hybrid85, sharded-chunk at world size 1 and public ``sddmm`` on the
    random pattern (K7 also random p=1, tri-random p=2 and random-fused,
    whose K12 computes K7's gradA); for K8 :func:`k8_steps` (with each
    step's K8 launches), for K9 :func:`k9_steps`, for K10
    :func:`k10_steps` (with each step's K10 and K11 launches).  Run in
    turns from two checkouts to compare them on one card.  Prints one
    JSON line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from torchsparsegradutils_tpu_torch import (sddmm, sparse_mm,
                                                sparse_triangular_solve)
    from torchsparsegradutils_tpu_torch.kernels import _build, dia, dia_tri
    from torchsparsegradutils_tpu_torch.kernels.chunk_lse import (
        lse_rows, lse_rows_bwd)
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        build_chunk_plan, chunk_spmv)
    from torchsparsegradutils_tpu_torch.kernels.dia import (build_dia_plan,
                                                            values_to_grid)
    from torchsparsegradutils_tpu_torch.parallel import (
        build_sharded_chunk_plan, sharded_chunk_spmm, sharded_dia_spmm)
    from torchsparsegradutils_tpu_torch.utils.random_sparse import (
        hybrid_sparse, rand_sparse, rand_sparse_tri, stencil_sparse)
    dev = torch.device("cuda", 0)
    card = smi_line()
    _build.libraries()
    gen = torch.Generator().manual_seed(0)
    A = stencil_sparse((N, N), STENCIL_OFFSETS, generator=gen, device=dev)
    plan = build_dia_plan(A.row_sa(), A.col_sa(), N, N)
    B = torch.randn(N, P, generator=gen).to(dev)
    G = torch.randn(N, P, generator=gen).to(dev)
    H = None if which == "k10" else hybrid_sparse(
        (N, N), STENCIL_OFFSETS, NNZ_HYBRID, dia_coverage=0.85,
        generator=gen, device=dev)
    if which in ("k6", "k7", "k8", "k9", "k10"):
        R = rand_sparse((N, N), NNZ_RANDOM, layout="csr", generator=gen,
                        device=dev)
        cplan = build_chunk_plan(R.row_sa(), R.col_sa(), N, N)
        plan1 = build_sharded_chunk_plan(R, 1)
    if which == "k8":
        res = {"k8": k8_times(R, cplan, lse_skewed(gen, dev), H, dev)}
    elif which == "k10":
        S = lse_skewed(gen, dev)
        res = {"k10": k10_times(build_chunk_plan(S.row_sa(), S.col_sa(), N,
                                                 N), S.values, cplan,
                                R.values, gen, dev)}
    elif which == "k9":
        T = stencil_sparse((N, N), TRI_OFFSETS, well_conditioned=True,
                           generator=gen, device=dev)
        tplan = build_dia_plan(T.row_sa(), T.col_sa(), N, N)
        TB = torch.randn(N, P, generator=gen).to(dev)
        res = {"k9": k9_times(T, tplan, values_to_grid(tplan, T.values), TB,
                              G, dev)}
    elif which == "k6":
        res = {"k6": k6_times(R, cplan, H, B, G, dev),
               "k13": k13_times(R, (plan1, build_sharded_chunk_plan(R, 4)),
                                B, dev)}
    elif which == "k7":
        res = {"k7": k7_times(R, cplan, H, B, G, dev)}
    elif which == "k1":
        res = {"k1": k1_times(A, plan, values_to_grid(plan, A.values), B, G,
                              dev)}
    else:
        res = {"k2": k2_times(A, plan, B, G, dev)}

    def step(M, p):
        return chained_step(lambda v, b: sparse_mm(M.with_data(v), b),
                            M.values, B[:, :p].contiguous(),
                            G[:, :p].contiguous())

    def fused(fn):
        def run():
            dia.SPMM_BWD = "fused"
            try:
                fn()
            finally:
                dia.SPMM_BWD = "split"
        return run
    steps = {}
    with one_rank_group(dev):
        if which in ("k6", "k7"):
            C = torch.randn(R.nnz, generator=gen).to(dev)
            todo = [("random", step(R, P)), ("hybrid85", step(H, P)),
                    ("sharded_chunk", chained_step(
                        lambda v, b: sharded_chunk_spmm(plan1, v, b),
                        R.values, B, G)),
                    ("random_sddmm", chained_step(
                        lambda x, y: sddmm(R, x, y).values, G, B, C))]
        if which == "k7":
            TR = rand_sparse_tri((N, N), NNZ_TRI_RANDOM, upper=False,
                                 layout="csr", generator=gen, device=dev)
            todo += [("random_p1", step(R, 1)),
                     ("tri_random_p2", chained_step(
                         lambda v, b: sparse_triangular_solve(
                             TR.with_data(v), b, upper=False),
                         TR.values, B[:, :2].contiguous(),
                         G[:, :2].contiguous())),
                     ("random_fused", fused(step(R, P)))]
        elif which == "k9":
            todo = k9_steps(A, H, R, T, plan1, B, G, TB, gen, dev, steps)
        elif which == "k10":
            todo = k10_steps(A, R, S, B, G)
        elif which == "k8":
            todo = k8_steps(A, R, B, G)
        elif which != "k6":
            f = sharded_dia_spmm(A)
            todo = [("stencil", step(A, P)), ("hybrid85", step(H, P)),
                    ("stencil_p16", step(A, 16)),
                    ("sharded_dia", chained_step(f, A.values, B, G))]
        if which == "k2":
            T = stencil_sparse((N, N), TRI_OFFSETS, well_conditioned=True,
                               generator=gen, device=dev)
            todo.append(("tri_stencil_p2", chained_step(
                lambda v, b: sparse_triangular_solve(T.with_data(v), b,
                                                     upper=False),
                T.values, B[:, :2].contiguous(), G[:, :2].contiguous())))
        for label, fn in todo:
            name = label if label.endswith(("_fwd", "_bwd")) \
                else f"{label}_fwd_bwd"
            if which == "k9":
                before = dia_tri.tri_dia_core.launches
                fn()
                torch.cuda.synchronize()
                steps[f"{name}_k9_launches"] = \
                    dia_tri.tri_dia_core.launches - before
            if which == "k8":
                before = chunk_spmv.launches
                fn()
                torch.cuda.synchronize()
                steps[f"{name}_k8_launches"] = chunk_spmv.launches - before
            if which == "k10":
                before = (lse_rows.launches, lse_rows_bwd.launches)
                fn()
                torch.cuda.synchronize()
                steps[f"{label}_k10_launches"] = \
                    lse_rows.launches - before[0]
                steps[f"{label}_k11_launches"] = \
                    lse_rows_bwd.launches - before[1]
            if which == "k7" and label in ("random", "random_fused"):
                # the split and fused backwards' memory: one step's peak
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                fn()
                torch.cuda.synchronize()
                steps[f"{name}_peak_extra_mib"] = (
                    torch.cuda.max_memory_allocated() - base) / 2**20
            steps[f"{name}_ms"] = time_ms(
                fn, reps=10 if label.startswith(("tri", "flagship")) else 50,
                warmup=1 if label.startswith("tri_random") else 3)
            # the device's share, which the host's pace does not move
            steps[f"{name}_device_ms"] = device_ms(fn, "", reps=10)
    res["steps"] = steps
    print(json.dumps({f"{which}_compare": res, "card": card}))
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
    n = R.shape[0]
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
    times = k13_times(R, (plan1, plan4), B, dev)
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


# the solver phase (3e), at cfd2 width in float32: the suite's matrices
# (benchmarks/sparse_solve_suite.py:35-104) and a tall least-squares one
SPD_OFFSETS = [1, 2, 3, 49, 50, 51, 2401, 2449, 2450, 2451, 2499, 2500]
NNZ_SPD_STENCIL = 3_056_188   # 25 diagonals, cut at the borders
N_SPD_RANDOM = 65_536         # make_spd_sparse(n, 9 n), the suite's random
LSQ_SHAPE = (131_072, 65_536)
NNZ_LSQ = 1_048_576
SOLVE_ST = dict(max_iter=200, rtol=1e-5)   # the suite's settings
SOLVE_RES = 1e-4      # relative residual and Aᵀ gradB, in float64
# matvecs of a solver: each loop step's, and those before its loop
MATVECS = {"linear_cg": (1, 0), "minres": (1, 0), "bicgstab": (2, 0),
           "lsmr": (2, 1)}
SOLVE_REPS = 2        # timed repeats of each solve


def plain_mv(A, x, transpose=False):
    """A x (or Aᵀ x) in float64 by gather and ``index_add`` (no kernel)."""
    import torch
    rows, cols = A.rows_t(), A.cols_t()
    n = A.shape[0]
    if transpose:
        rows, cols, n = cols, rows, A.shape[1]
    x = x.double()
    x2 = x[:, None] if x.ndim == 1 else x
    out = torch.zeros((n, x2.shape[1]), dtype=torch.float64,
                      device=x.device)
    out.index_add_(0, rows, A.values.double()[:, None] * x2[cols])
    return out[:, 0] if x.ndim == 1 else out


def rel(a, b):
    return ((a - b).norm() / b.norm()).item()


class Recorder:
    """A solver for ``sparse_generic_solve`` / ``sparse_generic_lstsq``
    that calls a Krylov solver and records each solve in ``log`` (shared
    by a solve and its transpose solve, so in the order they ran): name,
    iterations, loop steps (each runs the solver's matvecs once) and host
    reads."""

    def __init__(self, krylov, log, transpose=False):
        self.krylov, self.log, self.transpose = krylov, log, transpose

    def __call__(self, A, B, **kw):
        from torchsparsegradutils_tpu_torch.solvers import common
        name = self.krylov.__name__
        steps, reads = common.while_loop.steps, common.host_read.reads
        M = A.T if self.transpose else A
        if name == "lsmr":
            x, it = self.krylov(M, B, **kw)
        else:
            x, info = self.krylov(M, B, diagnostics=True, **kw)
            it = info.iterations
        self.log.append({"solver": name, "iterations": it,
                         "steps": common.while_loop.steps - steps,
                         "reads": common.host_read.reads - reads})
        return x


def take(log):
    """The solves recorded in ``log`` since the last take, emptying it."""
    out = [dict(e, iterations=int(e["iterations"])) for e in log]
    log.clear()
    return out


def solve_timing(run, reps=SOLVE_REPS):
    """Wall and CUDA-event ms of ``run()`` (one solve, or forward and
    backward) over ``reps`` calls, each timed alone (a solve reads the
    card itself), and the profiled device ms (kernels only) of one more
    call; the busy share is device ms over the unprofiled wall ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    wall, event = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        event.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    rows = sorted(((e.key, e.self_device_time_total / 1e3)
                   for e in kernels), key=lambda r: -r[1])
    dev_ms = sum(t for _, t in rows)
    w = sum(wall) / reps
    return {"wall_ms": w, "wall_ms_runs": wall, "event_ms": sum(event) / reps,
            "device_ms": dev_ms, "busy_share": dev_ms / w,
            "kernel_launches": sum(e.count for e in kernels),
            "top": [[k[:50], t] for k, t in rows[:5]]}


@contextlib.contextmanager
def syncs_seen(where):
    """Record in ``where`` each host sync that
    ``torch.cuda.set_sync_debug_mode`` reports inside the block (every
    one, not only the solvers' counted reads), by the line that made
    it."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in seen:
        # the mode's own notice ("... is a prototype feature ...") is no
        # sync
        if "synchroniz" in str(w.message) \
                and "prototype feature" not in str(w.message):
            key = f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}"
            where[key] = where.get(key, 0) + 1


def drive_solve(label, op, A, b, solver, kernel, also, kw, fwd_also=()):
    """One forward, then one forward+backward of ``(x**2).sum()``, of
    ``op`` (``sparse_generic_solve`` or ``sparse_generic_lstsq``) with the
    recording ``solver`` pair, the counters set to 0 just before each and
    read just after: ``kernel`` (the matvec's) must launch once per
    matvec, ``fwd_also`` in both runs and ``also`` in the backward; no
    plain version may run, and no solve may read the card more than
    once a ``CHECK_EVERY`` steps and once at its end.  The
    checks, then the times.  Returns the phase's record of the solve."""
    import torch
    from torchsparsegradutils_tpu_torch.solvers import common
    lstsq = op.__name__ == "sparse_generic_lstsq"
    solver_kw = (dict(lstsq=solver[0], transpose_lstsq=solver[1]) if lstsq
                 else dict(solve=solver[0], transpose_solve=solver[1]))

    def fwd():
        with torch.no_grad():
            return op(A, b, **solver_kw, **kw)

    def fwd_bwd():
        v = A.values.detach().clone().requires_grad_(True)
        bb = b.detach().clone().requires_grad_(True)
        x = op(A.with_data(v), bb, **solver_kw, **kw)
        gv, gb = torch.autograd.grad((x ** 2).sum(), (v, bb))
        return x, gv, gb

    rec = {}
    for what, run in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        t_cfg = time.perf_counter()
        zero_counters()
        syncs = {}
        with syncs_seen(syncs):
            out = run()
        log = take(solver[0].log)
        expect = (kernel,) + fwd_also + (also if what == "fwd_bwd" else ())
        launches = read_counters(f"{label} {what}", expect)
        plain = {k: v for k, v in PLAIN.items() if v}
        if plain:
            raise AssertionError(f"{label} {what}: plain versions ran: "
                                 f"{plain}")
        mvs = sum(e["steps"] * MATVECS[e["solver"]][0]
                  + MATVECS[e["solver"]][1] for e in log)
        if what == "fwd_bwd" and lstsq:
            mvs += 1                     # the backward's A x
        if launches[kernel] != mvs:
            raise AssertionError(f"{label} {what}: {kernel} launched "
                                 f"{launches[kernel]} times for {mvs} "
                                 "matvecs")
        for e in log:       # the loop's reads, and the warning's
            most = max(1, -(-e["iterations"] // common.CHECK_EVERY)) + (
                e["solver"] != "lsmr")
            if e["reads"] > most:
                raise AssertionError(f"{label} {what}: {e['reads']} host "
                                     f"reads in a solve of {e}")
        r = {"solves": log, "matvecs": mvs, "host_syncs": syncs,
             "launches": {k: v for k, v in launches.items() if v}}
        x = out if what == "fwd" else out[0]
        if not (torch.isfinite(x).all() and x.shape[0] == A.shape[1]):
            raise AssertionError(f"{label} {what}: bad x")
        if lstsq:
            ax_b = plain_mv(A, x) - b.double()
            r["rel_residual"] = ax_b.norm().item() / b.double().norm().item()
            r["normal_eq_residual"] = (plain_mv(A, ax_b, True).norm()
                                       / (A.values.double().norm()
                                          * ax_b.norm())).item()
        else:
            r["rel_residual"] = rel(plain_mv(A, x), b.double())
            if not r["rel_residual"] <= SOLVE_RES:
                raise AssertionError(f"{label} {what}: relative residual "
                                     f"{r['rel_residual']:.3e} > "
                                     f"{SOLVE_RES}")
        if what == "fwd_bwd":
            _, gv, gb = out
            g = 2 * x.double()
            # gradB = A⁻ᵀ g, or (Aᵀ)⁺ g for least squares: Aᵀ gradB = g
            r["gradB_rel"] = rel(plain_mv(A, gb, True), g)
            if not (torch.isfinite(gv).all() and torch.isfinite(gb).all()):
                raise AssertionError(f"{label}: non-finite gradients")
            if not lstsq:
                gb2 = gb.double()[:, None] if gb.ndim == 1 else gb.double()
                x2 = x.double()[:, None] if x.ndim == 1 else x.double()
                ref = -(gb2[A.rows_t()] * x2[A.cols_t()]).sum(-1)
                r["gradA_max_abs_err"] = close(
                    f"{label} gradA vs plain SDDMM f64", gv, ref, "float32")
                if not r["gradB_rel"] <= SOLVE_RES:
                    raise AssertionError(
                        f"{label}: |Aᵀ gradB - g| / |g| = "
                        f"{r['gradB_rel']:.3e} > {SOLVE_RES}")
        r.update(solve_timing(run))
        timed = take(solver[0].log)
        per_call = len(timed) // (SOLVE_REPS + 1)
        iters = sum(e["iterations"] for e in timed[:per_call])
        r["reads_per_call"] = sum(e["reads"] for e in timed[:per_call])
        r["iterations"] = iters
        r["device_ms_per_iter"] = r["device_ms"] / max(iters, 1)
        r["wall_ms_per_iter"] = r["wall_ms"] / max(iters, 1)
        r["steps"] = sum(e["steps"] for e in timed[:per_call])
        r["timed_iterations"] = [[e["iterations"] for e in timed[
            c * per_call:(c + 1) * per_call]] for c in range(SOLVE_REPS + 1)]
        r["wall_us_per_launch"] = 1e3 * r["wall_ms"] / r["kernel_launches"]
        print(f"  {label} {what}: {iters} iterations "
              f"({[e['iterations'] for e in log]} in the checked call), "
              f"residual {r['rel_residual']:.3e}, wall {r['wall_ms']:.2f} "
              f"ms, device {r['device_ms']:.2f} ms, busy "
              f"{r['busy_share']:.3f}, {r['kernel_launches']} launches, "
              f"reads {r['reads_per_call']}, syncs "
              f"{r['host_syncs']}, {time.perf_counter() - t_cfg:.1f} s")
        rec[what] = r
    return rec


def phase_solvers(dev, card):
    """Phase 3e: ``sparse_generic_solve`` and ``sparse_generic_lstsq``
    over the Krylov solvers at cfd2 width, float32.

    *stencil SPD* (``make_spd_stencil(123_440, SPD_OFFSETS)``, 25
    diagonals, the DIA route: K1, with K2 and K3 in the backward) with
    CG, MINRES and BiCGSTAB at one right-hand side and CG at 8; *random
    SPD* (``make_spd_sparse(65_536, 9 * 65_536)``, the chunk route: K8,
    K7 in the backward) with CG and MINRES; *least squares*, the default
    LSMR on a tall random matrix of 131,072 x 65,536 with 1,048,576
    entries and every column filled.  Each forward and forward+backward
    of ``(x**2).sum()``: the launch counts (the matvec kernel once per
    matvec, no plain version), the relative residual and ``Aᵀ gradB``
    against the cotangent in float64, gradA against the plain SDDMM in
    float64, a small case against a dense solve, then the times.  Prints
    one ``solvers`` JSON line."""
    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch import (
        make_spd_sparse, make_spd_stencil, sparse_generic_lstsq,
        sparse_generic_solve)
    from torchsparsegradutils_tpu_torch import solvers as ps
    from torchsparsegradutils_tpu_torch.solvers import common
    from torchsparsegradutils_tpu_torch.utils.random_sparse import (
        rand_sparse)

    gen = torch.Generator().manual_seed(15)
    # a small case against a dense solve in float64
    Sm = make_spd_stencil(2000, [1, 40], generator=gen, device=dev)
    bs = torch.randn(2000, generator=gen).to(dev)
    x = sparse_generic_solve(Sm, bs, solve=ps.linear_cg, settings=ps.
                             LinearCGSettings(max_iter=400, rtol=1e-6))
    ref = torch.linalg.solve(Sm.todense().double(), bs.double())
    close("small stencil CG vs dense solve f64", x, ref, "float32",
          (1e-4, 1e-5))
    Lm = rand_sparse((3000, 1000), 20_000, layout="csr", generator=gen,
                     device=dev)
    bl = torch.randn(3000, generator=gen).to(dev)
    # the default LSMR's tolerance in tests/test_lstsq.py
    close("small lstsq vs dense lstsq f64", sparse_generic_lstsq(Lm, bl),
          torch.linalg.lstsq(Lm.todense().double().cpu(),
                             bl.double().cpu()[:, None]).solution[:, 0].to(
                                 dev), "float32", (5e-2, 5e-3))

    t1 = time.perf_counter()
    A = make_spd_stencil(N, SPD_OFFSETS, layout="csr", generator=gen,
                         device=dev)
    R = make_spd_sparse(N_SPD_RANDOM, 9 * N_SPD_RANDOM, layout="csr",
                        generator=gen, device=dev)
    L = rand_sparse(LSQ_SHAPE, NNZ_LSQ, layout="csr", generator=gen,
                    device=dev)
    if A.nnz != NNZ_SPD_STENCIL:
        raise AssertionError(f"stencil SPD: {A.nnz} entries")
    empty = int((np.bincount(L.cols(), minlength=LSQ_SHAPE[1]) == 0).sum())
    if empty:
        raise AssertionError(f"least squares: {empty} empty columns")
    print(f"  matrices built in {time.perf_counter() - t1:.1f} s: stencil "
          f"SPD {A.nnz}, random SPD {R.nnz}, tall {L.nnz} entries")
    b = torch.randn(N, generator=gen).to(dev)
    b8 = torch.randn(N, 8, generator=gen).to(dev)
    br = torch.randn(N_SPD_RANDOM, generator=gen).to(dev)
    bl = torch.randn(LSQ_SHAPE[0], generator=gen).to(dev)

    def pair(krylov, transpose=False):
        """A solver and its transpose solver (``krylov`` itself where A
        is symmetric), recording into one log."""
        log = []
        return Recorder(krylov, log), Recorder(krylov, log, transpose)

    dia_bwd = ("dia_sddmm", "gather")
    out = {}
    for name, krylov, settings in (
            ("cg", ps.linear_cg, ps.LinearCGSettings(**SOLVE_ST)),
            ("minres", ps.minres, ps.MINRESSettings(**SOLVE_ST)),
            ("bicgstab", ps.bicgstab, ps.BICGSTABSettings(**SOLVE_ST))):
        st = dict(settings=settings)
        out[f"stencil_{name}"] = drive_solve(
            f"stencil SPD {name}", sparse_generic_solve, A, b, pair(krylov),
            "dia_spmm", dia_bwd, st, ("gather",))
        if name == "cg":
            out["stencil_cg_p8"] = drive_solve(
                "stencil SPD cg p=8", sparse_generic_solve, A, b8,
                pair(krylov), "dia_spmm", dia_bwd, st, ("gather",))
        if name != "bicgstab":
            out[f"random_{name}"] = drive_solve(
                f"random SPD {name}", sparse_generic_solve, R, br,
                pair(krylov), "chunk_spmv", ("chunk_sddmm",), st)
    out["lstsq_lsmr"] = drive_solve(
        "least squares lsmr", sparse_generic_lstsq, L, bl,
        pair(ps.lsmr, transpose=True), "chunk_spmv",
        ("chunk_sddmm",), {}, ("gather",))
    print(json.dumps({"solvers": out, "check_every": common.CHECK_EVERY,
                      "card": card}))
    return out


# the model phase (3f), at the flagship's width in float32: the encoder
# of parallel/training.py:make_model, strictly lower for the LDLᵀ forms
# and with its diagonal stored for the LLᵀ forms
MODEL_VOLUME = (1, 48, 48, 48)
MODEL_NNZ = 961_056          # strictly lower entries (9 offsets)
MODEL_S = 128                # samples, and observations
MODEL_FORMS = {"cov_llt": (True, False), "cov_ldlt": (True, True),
               "prec_llt": (False, False), "prec_ldlt": (False, True)}
MODEL_RES = 1e-5             # the precision forms' solve residual
MODEL_REPS = 3               # timed repeats of each call
FIT_STEPS = 5   # Adam steps of the example's step (examples/fit_sparse_gmrf.py)


@contextlib.contextmanager
def plain_kernels():
    """Every kernel of the model path (K1, K2, K3 and K9) swapped for its
    plain PyTorch version on the card, at the module attributes its
    callers read: the reference of phase 3f."""
    import numpy as np
    from torchsparsegradutils_tpu_torch.kernels import dia, dia_tri
    from torchsparsegradutils_tpu_torch.kernels import window_gather as wg
    from torchsparsegradutils_tpu_torch.ops import triangular_solve as ts
    saved = [(dia, "spmm_core", dia.spmm_core),
             (dia, "sddmm_core", dia.sddmm_core),
             (wg, "window_gather", wg.window_gather),
             (ts, "tri_dia_core", ts.tri_dia_core)]
    spmm, sddmm = dia.spmm_core_plain, dia.sddmm_core_plain
    gather, tri = wg.window_gather_plain, dia_tri.tri_dia_core_plain
    dia.spmm_core = lambda offs, grid, B, geo=None: spmm(offs, grid, B)
    dia.sddmm_core = lambda offs, X, Y, geo=None: sddmm(offs, X, Y)
    wg.window_gather = gather
    ts.tri_dia_core = lambda offs, grid, B, *, unit: tri(
        np.asarray(offs, np.int64), grid, B, unit=unit)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def model_values(enc, gen, scale):
    """Encoder values: ``scale · N(0, 1)`` off the diagonal, and a stored
    diagonal of ``1 + 0.1 |N(0, 1)|`` (diagonally dominant factors)."""
    import torch
    vals = scale * torch.randn((len(enc.offsets),) + enc.volume_shape,
                               generator=gen)
    for k, off in enumerate(enc.offsets):
        if not any(off):
            vals[k] = 1.0 + 0.1 * (vals[k] / scale).abs()
    return vals


def model_expect(form, call, what):
    """The kernels a model call must launch: K1 for the covariance
    samples, K9 (and its block inverses) for the precision samples and
    the covariance ``log_prob``, K3 for the value relayouts, K2 for the
    gradient at the factor's pattern.  The precision ``log_prob`` runs
    ``sparse_mm(L.T, ·)`` on an unsorted COO transpose: the generic
    branch, no kernel."""
    cov = MODEL_FORMS[form][0]
    if call == "log_prob" and not cov:
        return ()
    main = (("dia_spmm",) if cov and call == "rsample"
            else ("tri_dia", "tri_dia_inv"))
    return main + ("gather",) + (("dia_sddmm",) if what == "fwd_bwd"
                                 else ())


def phase_models(dev, card):
    """Phase 3f: ``SparseMultivariateNormal`` at the flagship's width.

    The ``PairwiseEncoder(1.5, (1, 48, 48, 48))`` factor (n = 110,592,
    961,056 strictly lower entries; the diagonal stored too for the LLᵀ
    forms), float32, S = 128.  For each of the four parameterisations,
    ``rsample`` forward and forward+backward of ``(x**2).sum()`` and
    ``log_prob`` forward and forward+backward of its sum: the launch
    counts (:func:`model_expect`; no plain version at all), the outputs
    and the gradients of ``loc``, ``diagonal`` and the factor's values
    against the same calls with every kernel on its plain version on the
    card, the precision forms' solve residual through ``sparse_mm``, then
    the times.  Then five Adam steps of a GMRF fit (prec-LDLᵀ, 128
    observations from a ground-truth model): the loss must fall.  Prints
    one ``models`` JSON line."""
    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch import sparse_mm
    from torchsparsegradutils_tpu_torch.examples import (
        fit_sparse_gmrf as fit_example)
    from torchsparsegradutils_tpu_torch.models import (
        PairwiseEncoder, SparseMultivariateNormal)

    t1 = time.perf_counter()
    gen = torch.Generator().manual_seed(16)
    encs = {ldlt: PairwiseEncoder(1.5, MODEL_VOLUME, diag=not ldlt,
                                  upper=False, layout="coo")
            for ldlt in (False, True)}
    factors = {ldlt: enc(model_values(enc, gen, 0.05).to(dev))
               for ldlt, enc in encs.items()}
    n = encs[True].volume_numel
    if factors[True].nnz != MODEL_NNZ or factors[False].nnz != MODEL_NNZ + n:
        raise AssertionError(f"model factors: {factors[True].nnz} and "
                             f"{factors[False].nnz} entries")
    loc = (0.1 * torch.randn(n, generator=gen)).to(dev)
    D = torch.exp(0.2 * torch.randn(n, generator=gen)).to(dev)
    print(f"  factors built in {time.perf_counter() - t1:.1f} s: n {n}, "
          f"{factors[True].nnz} and {factors[False].nnz} entries")

    def dist(form, grad):
        cov, ldlt = MODEL_FORMS[form]
        L = factors[ldlt]
        leaves = [L.values.detach().clone(), loc.detach().clone()] + (
            [D.detach().clone()] if ldlt else [])
        for x in leaves:
            x.requires_grad_(grad)
        kw = {"scale_tril" if cov else "precision_tril":
              L.with_data(leaves[0])}
        return SparseMultivariateNormal(
            leaves[1], leaves[2] if ldlt else None, **kw), leaves

    def eps_gen():
        return torch.Generator(device=dev).manual_seed(161)

    obs = {}
    for form in MODEL_FORMS:
        obs[form] = dist(form, False)[0].sample(
            (MODEL_S,), generator=torch.Generator(device=dev).manual_seed(
                162))

    def call_fn(form, call, what):
        def run():
            grad = what == "fwd_bwd"
            with torch.set_grad_enabled(grad):
                d, leaves = dist(form, grad)
                if call == "rsample":
                    out = d.rsample((MODEL_S,), generator=eps_gen())
                    loss = (out ** 2).sum()
                else:
                    out = d.log_prob(obs[form])
                    loss = out.sum()
                if not grad:
                    return (out,)
                return (out,) + torch.autograd.grad(loss, leaves)
        return run

    names = ("out", "grad_values", "grad_loc", "grad_diagonal")
    rec = {}
    for form, (cov, ldlt) in MODEL_FORMS.items():
        for call in ("rsample", "log_prob"):
            for what in ("fwd", "fwd_bwd"):
                label = f"{form} {call} {what}"
                run = call_fn(form, call, what)
                zero_counters()
                got = run()
                expect = model_expect(form, call, what)
                launches = read_counters(label, expect)
                plain = {k: v for k, v in PLAIN.items() if v}
                if plain:
                    raise AssertionError(f"{label}: plain versions ran: "
                                         f"{plain}")
                r = {"launches": {k: v for k, v in launches.items() if v}}
                with plain_kernels():
                    ref = run()
                r["max_abs_err"] = {
                    nm: close(f"{label} {nm} vs plain", g, rf, "float32")
                    for nm, g, rf in zip(names, got, ref)}
                if call == "rsample" and what == "fwd" and not cov:
                    # (I + L)ᵀ x = ε/√D (Lᵀ x = ε for LLᵀ), x the centred
                    # samples
                    X = (got[0] - loc).T
                    L = factors[ldlt]
                    E = torch.randn((MODEL_S, n), generator=eps_gen(),
                                    device=dev).T
                    lhs = sparse_mm(L.T, X) + (X if ldlt else 0)
                    rhs = E / torch.sqrt(D)[:, None] if ldlt else E
                    r["residual"] = rel(lhs, rhs)
                    print(f"  {label}: solve residual "
                          f"{r['residual']:.3e}")
                    if not r["residual"] <= MODEL_RES:
                        raise AssertionError(
                            f"{label}: solve residual {r['residual']:.3e} "
                            f"> {MODEL_RES}")
                del got, ref
                r.update(solve_timing(run, MODEL_REPS))
                print(f"  {label}: wall {r['wall_ms']:.2f} ms, event "
                      f"{r['event_ms']:.2f} ms, device "
                      f"{r['device_ms']:.2f} ms, busy "
                      f"{r['busy_share']:.3f}, {r['kernel_launches']} "
                      "launches")
                rec[f"{form}_{call}_{what}"] = r

    # a GMRF fit, as examples/fit_sparse_gmrf.py: prec-LDLᵀ over the
    # strictly lower encoder, 128 observations from a ground truth
    enc = encs[True]
    truth = SparseMultivariateNormal(
        torch.zeros(n, device=dev),
        torch.exp(0.2 * torch.randn(n, generator=gen)).to(dev),
        precision_tril=enc(model_values(enc, gen, 0.05).to(dev)))
    batch = truth.sample((MODEL_S,), generator=torch.Generator(
        device=dev).manual_seed(163))
    params = fit_example.init_params(enc, dev)
    opt = torch.optim.Adam(params.values(), lr=fit_example.LR)
    losses, walls = [], []
    zero_counters()
    for _ in range(FIT_STEPS):
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        losses.append(fit_example.step(params, opt, enc, batch).item())
        walls.append((time.perf_counter() - t_step) * 1e3)
    fit_launches = read_counters("gmrf fit", ())
    print(f"  gmrf fit: losses {losses}, step wall ms {walls}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"gmrf fit: loss did not fall: {losses}")
    fit = {"losses": losses, "step_wall_ms": walls,
           "launches": {k: v for k, v in fit_launches.items() if v}}
    print(json.dumps({"models": rec, "gmrf_fit": fit, "n": n,
                      "nnz_strict": MODEL_NNZ, "samples": MODEL_S,
                      "card": card}))
    return rec


# phase 3g: the ELL engine, distributed solves, interop and explain
ELL_PATTERNS = ("stencil", "random", "hybrid85")   # the three cfd2 patterns
DIST_N = 131_072        # examples/distributed_stencil_solve.py:37-40
DIST_OFFSETS = [-2048, -32, -1, 0, 1, 32, 2048]
DIST_ST = dict(max_iter=400, rtol=1e-6)
SCIPY_GRID = 256        # spsolve on the 256 x 256 5-point stencil
# explain's kernel labels -> the launch counters
LABEL_COUNTER = {"K1": "dia_spmm", "K2": "dia_sddmm", "K3": "gather",
                 "K6": "chunk_spmm", "K7": "chunk_sddmm", "K8": "chunk_spmv",
                 "K9": "tri_dia", "K10": "lse_rows", "K11": "lse_rows_bwd",
                 "K12": "chunk_bwd_cols"}


def launched_labels(launches):
    return {k for k, c in LABEL_COUNTER.items() if launches.get(c)}


def check_explain(seen):
    """``explain``'s engine and kernels against the routes a run took:
    ``seen`` holds (label, op, matrix, p, launches, routes) of runs whose
    counters were set to 0 just before and read just after.  SpMM and
    SDDMM: the kernels launched are the ones named; the triangular
    solve: the forward's route; the LSE ops: the row route's kernels
    launched, K10 and K11 only where it is the chunk route."""
    from torchsparsegradutils_tpu_torch import explain
    out = {}
    for label, op, M, p, launches, routes in seen:
        rep = explain(M, p=p)[op]
        got = launched_labels(launches)
        want = set(rep["kernels"])
        if op in ("sparse_mm", "sddmm"):
            ok = got == want
        elif op == "triangular_solve":
            ok = routes[:1] == [rep["engine"]] and want <= got
        else:
            ok = want <= got and ("K10" in got) == ("K10" in want)
        print(f"  explain {label} {op}: engine {rep['engine']}, kernels "
              f"{sorted(want)}; launched {sorted(got)}"
              + (f", route {routes[:1]}" if routes else ""))
        if not ok:
            raise AssertionError(f"explain {label} {op}: {rep} does not "
                                 f"match the run ({sorted(got)}, {routes})")
        out[f"{label} {op}"] = rep["engine"]
    return out


def ell_cell(label, M, B, G, default_ms):
    """``sparse_mm(..., backend="ell")`` fwd+bwd: K3 must launch and no
    plain version run; values and gradients against the generic route;
    the plan's K, padding and K-chunks, peak extra memory, wall, event
    and device ms of a chained step beside the default engine's."""
    import torch
    from torchsparsegradutils_tpu_torch import sparse_mm
    from torchsparsegradutils_tpu_torch.kernels.ell import (build_ell_plan,
                                                            k_chunks)
    n, m = M.shape
    t1 = time.perf_counter()
    rp = build_ell_plan(M.row_sa(), M.col_sa(), n, m)
    cp = build_ell_plan(M.col_sa(), M.row_sa(), m, n)
    plan_s = time.perf_counter() - t1
    zero_counters()
    got, mib = peak_extra(lambda: fwd_bwd(M, B, G, "ell"))
    launches = read_counters(f"ell {label}", ("gather",), ("gather_plain",))
    if any(PLAIN.values()):
        raise AssertionError(f"ell {label}: plain versions ran: {PLAIN}")
    err = {name: close(f"ell {label} {name} vs generic path", g_, r_,
                       "float32")
           for name, g_, r_ in zip(("out", "gradA", "gradB"), got,
                                   fwd_bwd(M, B, G, "xla"))}
    del got
    step = chained_step(lambda v, b: sparse_mm(M.with_data(v), b,
                                               backend="ell"),
                        M.values, B, G)
    t0 = time.perf_counter()
    event = time_ms(step, reps=5, warmup=1)
    wall = (time.perf_counter() - t0) * 1e3 / 6
    rec = {"K": rp.K if rp else None, "K_T": cp.K if cp else None,
           "padding": rp.K * n / M.nnz if rp else None,
           "k_chunks": len(k_chunks(rp, B.shape[1])) if rp else 0,
           "plan_host_s": plan_s, "fwd_bwd_peak_extra_mib": mib,
           "fwd_bwd_event_ms": event, "fwd_bwd_wall_ms": wall,
           "fwd_bwd_device_ms": device_ms(step, "", reps=3),
           "default_fwd_bwd_event_ms": default_ms,
           "launches": {k: v for k, v in launches.items() if v},
           "max_abs_err": err}
    profile_step(f"ell_{label}_fwd_bwd_step", step, steps=3, top=6)
    print(f"  ell {label}: K {rec['K']} (transpose {rec['K_T']}), "
          f"n·K/nnz {rec['padding']}, {rec['k_chunks']} K-chunks, peak "
          f"extra {mib:.1f} MiB, fwd+bwd {event:.3f} ms event, "
          f"{rec['fwd_bwd_device_ms']:.3f} ms device (default engine "
          f"{default_ms:.3f} ms)")
    torch.cuda.synchronize()
    return rec


def dist_solve(label, krylov, mv, mv_t, A, b, settings):
    """One solve over the closures on the one-rank group: bitwise the
    same closures' solve with no group; the residual in float64 by a
    plain gather and ``index_add``; iterations, host reads, all-reduces,
    K1 and K3 launches a loop step; wall and device ms."""
    import torch
    from torchsparsegradutils_tpu_torch.solvers import common
    lsmr = krylov.__name__ == "lsmr"

    def run(op, op_t):
        if lsmr:
            return krylov(op, b, rmatvec=op_t, settings=settings)
        return krylov(op, b, settings=settings, diagnostics=True)
    zero_counters()
    reads, steps = common.host_read.reads, common.while_loop.steps
    calls = common.group_sum.calls
    x, it = run(mv, mv_t)
    it = it if lsmr else it.iterations
    launches = read_counters(f"distributed {label}",
                             ("dia_spmm", "gather"))
    rec = {"iterations": int(it),
           "steps": common.while_loop.steps - steps,
           "host_reads": common.host_read.reads - reads,
           "all_reduces": common.group_sum.calls - calls,
           "k1_launches": launches["dia_spmm"],
           "k3_launches": launches["gather"]}
    if any(PLAIN.values()):
        raise AssertionError(f"distributed {label}: plain versions ran: "
                             f"{PLAIN}")
    ref = run(lambda v: mv(v), lambda v: mv_t(v))[0]
    if not torch.equal(x, ref):
        raise AssertionError(f"distributed {label}: not bitwise the solve "
                             "without a group")
    rec["rel_residual"] = rel(plain_mv(A, x), b.double())
    if not rec["rel_residual"] <= SOLVE_RES:
        raise AssertionError(f"distributed {label}: relative residual "
                             f"{rec['rel_residual']:.3e} > {SOLVE_RES}")
    per = max(rec["steps"], 1)
    rec.update({k + "_per_step": rec[k] / per for k in (
        "all_reduces", "k1_launches", "k3_launches")})
    t = solve_timing(lambda: run(mv, mv_t), reps=1)
    rec.update({k: t[k] for k in ("wall_ms", "event_ms", "device_ms",
                                  "busy_share", "kernel_launches")})
    print(f"  distributed {label}: {rec['iterations']} iterations "
          f"({rec['steps']} steps), {rec['host_reads']} host reads, "
          f"{rec['all_reduces_per_step']:.2f} all-reduces, "
          f"{rec['k1_launches_per_step']:.2f} K1 a step, residual "
          f"{rec['rel_residual']:.3e}, bitwise the plain solve, wall "
          f"{rec['wall_ms']:.1f} ms, device {rec['device_ms']:.2f} ms")
    return rec


def phase_interop(dev, card, seen=None, mats=None):
    """Phase 3g: the ELL engine, distributed Krylov solves, interop and
    ``explain``, at full width in float32.

    *ELL*: ``sparse_mm(backend="ell")`` fwd+bwd at p = 128 on the cfd2
    stencil, random and hybrid85 patterns against the generic route (K3
    launched, no plain version), with the plan's K and K-chunks, peak
    memory and times beside the default engine's step.  *Distributed
    solves* on a one-rank NCCL group: ``linear_cg`` over
    ``matvec_closures`` of the example's 7-point operator (n = 131,072)
    at ``max_iter=400, rtol=1e-6``, and the four drivers on phase 3e's
    stencil SPD; each bitwise the solve without a group, residual in
    float64 <= 1e-4.  *Interop*: ``sparse_solve_scipy`` (``spsolve`` on
    the 256 x 256 5-point stencil, ``cg`` on the stencil SPD) fwd+bwd,
    gradA on K2; ``sparse_mm_torch`` on the random pattern as a
    ``torch.sparse_csr`` tensor, bitwise ``sparse_mm``.  *explain*
    against the routes of ``seen`` (phase 3's runs), or of its own runs
    of the three patterns when run alone.  ``mats``: phase 2's stencil,
    random and hybrid85 matrices and its B and G, made here when run
    alone.  Prints one ``interop`` JSON line."""
    import torch
    from torchsparsegradutils_tpu_torch import (make_spd_stencil, solvers,
                                                sparse_mm)
    from torchsparsegradutils_tpu_torch.interop import (sparse_mm_torch,
                                                        sparse_solve_scipy)
    from torchsparsegradutils_tpu_torch.parallel import matvec_closures
    from torchsparsegradutils_tpu_torch.utils.random_sparse import (
        hybrid_sparse, rand_sparse, stencil_sparse)

    gen = torch.Generator().manual_seed(18)
    t0 = time.perf_counter()
    if mats is None:
        mats = {
            "stencil": stencil_sparse((N, N), STENCIL_OFFSETS, generator=gen,
                                      device=dev),
            "random": rand_sparse((N, N), NNZ_RANDOM, layout="csr",
                                  generator=gen, device=dev),
            "hybrid85": hybrid_sparse((N, N), STENCIL_OFFSETS, NNZ_HYBRID,
                                      dia_coverage=0.85, generator=gen,
                                      device=dev),
            "B": torch.randn(N, P, generator=gen).to(dev),
            "G": torch.randn(N, P, generator=gen).to(dev)}
    B, G = mats["B"], mats["G"]
    rec = {"card": card, "part_s": {}}

    def part(name):
        rec["part_s"][name] = time.perf_counter() - t0
        print(f"  3g {name} done at {rec['part_s'][name]:.1f} s")
    if seen is None:
        seen = []
        for label in ELL_PATTERNS:
            M = mats[label]
            zero_counters()
            fwd_bwd(M, B, G, "auto")
            seen.append((label, "sparse_mm", M, P, read_counters(
                f"{label} auto", ()), []))
    rec["explain"] = check_explain(seen)
    part("explain")

    print("  3g ELL: sparse_mm(backend='ell') fwd+bwd at p = 128")
    rec["ell"] = {}
    for label in ELL_PATTERNS:
        M = mats[label]
        default = time_ms(chained_step(lambda v, b, M=M: sparse_mm(
            M.with_data(v), b), M.values, B, G), reps=10)
        rec["ell"][label] = ell_cell(label, M, B, G, default)
    part("ell")

    print("  3g distributed solves on a one-rank NCCL group")
    rec["distributed"] = {}
    with one_rank_group(dev):
        A7 = make_spd_stencil(DIST_N, DIST_OFFSETS, generator=gen,
                              device=dev)
        mv, mv_t = matvec_closures(A7)
        b7 = torch.randn(DIST_N, 1, generator=gen).to(dev)
        rec["distributed"]["example_cg"] = dist_solve(
            "example 7-point cg", solvers.linear_cg, mv, mv_t, A7, b7,
            solvers.LinearCGSettings(**DIST_ST))
        del mv, mv_t
        S = make_spd_stencil(N, SPD_OFFSETS, layout="csr", generator=gen,
                             device=dev)
        mv, mv_t = matvec_closures(S)
        bs = torch.randn(N, 1, generator=gen).to(dev)
        for name, krylov, st in (
                ("cg", solvers.linear_cg, solvers.LinearCGSettings),
                ("minres", solvers.minres, solvers.MINRESSettings),
                ("bicgstab", solvers.bicgstab, solvers.BICGSTABSettings),
                ("lsmr", solvers.lsmr, None)):
            settings = (solvers.LSMRSettings() if st is None
                        else st(**SOLVE_ST))
            rec["distributed"][f"spd_{name}"] = dist_solve(
                f"stencil SPD {name}", krylov, mv, mv_t, S, bs, settings)
        del mv, mv_t
    part("distributed")

    print("  3g interop: SciPy host solves, the torch.sparse front end")
    rec["scipy"] = {}
    P5 = make_spd_stencil(SCIPY_GRID ** 2, [1, SCIPY_GRID], generator=gen,
                          device=dev)
    for label, method, M in (("spsolve 5-point", "spsolve", P5),
                             ("cg stencil SPD", "cg", S)):
        b = torch.randn(M.shape[0], generator=gen).to(dev)
        v = M.values.clone().requires_grad_(True)
        zero_counters()
        t_s = time.perf_counter()
        x = sparse_solve_scipy(M.with_data(v), b, method=method)
        (x ** 2).sum().backward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_s) * 1e3
        launches = read_counters(f"scipy {label}", ("dia_sddmm", "gather"))
        res = rel(plain_mv(M, x), b.double())
        g = 2 * x.detach().double()
        gb = sparse_solve_scipy(M, (2 * x).detach(), method=method)
        grad_b = rel(plain_mv(M, gb, True), g)
        ref = -(gb.double()[M.rows_t()] * x.detach().double()[M.cols_t()])
        err = close(f"scipy {label} gradA vs plain SDDMM f64", v.grad, ref,
                    "float32")
        if not (res <= SOLVE_RES and grad_b <= SOLVE_RES):
            raise AssertionError(f"scipy {label}: residual {res:.3e}, "
                                 f"Aᵀ gradB {grad_b:.3e} > {SOLVE_RES}")
        rec["scipy"][label] = {
            "n": M.shape[0], "nnz": M.nnz, "rel_residual": res,
            "gradB_rel": grad_b, "gradA_max_abs_err": err,
            "fwd_bwd_wall_ms": wall,
            "launches": {k: c for k, c in launches.items() if c}}
        print(f"  scipy {label}: residual {res:.3e}, Aᵀ gradB {grad_b:.3e}, "
              f"fwd+bwd wall {wall:.1f} ms, launches "
              f"{rec['scipy'][label]['launches']}")
    R = mats["random"]
    crow = torch.from_numpy(R.indptr_np().astype("int64")).to(dev)
    out = []
    for front in (True, False):
        v = R.values.clone().requires_grad_(True)
        b = B.clone().requires_grad_(True)
        zero_counters()
        y = (sparse_mm_torch(torch.sparse_csr_tensor(crow, R.cols_t(), v,
                                                     R.shape), b)
             if front else sparse_mm(R.with_data(v), b))
        out.append((y, *torch.autograd.grad(y, (v, b), G)))
        if front:
            launches = read_counters("sparse_mm_torch random", CHUNK_KERNELS)
    if not all(torch.equal(a, b_) for a, b_ in zip(*out)):
        raise AssertionError("sparse_mm_torch: not bitwise sparse_mm")
    rec["sparse_mm_torch"] = {"bitwise": True, "launches": {
        k: c for k, c in launches.items() if c}}
    print("  sparse_mm_torch random p=128: out, gradA, gradB bitwise "
          "sparse_mm's")
    part("interop")
    print(f"card: {card}")
    print(json.dumps({"interop": rec}))
    return rec


# phase 3h: device-resident (dynamic) sparsity patterns
KNN_K = 25                   # columns a row: N * 25 = 3,086,000 entries
DYN_TRI_N = 4096             # the dense fallback's n: a 64 MiB factor
DYN_TRI_NNZ = 8 * 4096
DYN_REPS = 10                # timed repeats of each dynamic step
LSE_TOL, LSE_GRAD_TOL = (1e-5, 1e-6), GRAD_TOL


def knn_pattern(gen):
    """``(indptr, cols)`` of a kNN-like CSR pattern made on the card:
    ``KNN_K`` distinct columns a row, sorted, drawn from ``gen`` (a CUDA
    generator); no host read."""
    import torch
    dev = gen.device
    draw = torch.randint(0, N - KNN_K, (N, KNN_K), generator=gen,
                         device=dev).sort(dim=1).values
    cols = (draw + torch.arange(KNN_K, device=dev)).reshape(-1)
    indptr = torch.arange(N + 1, device=dev) * KNN_K
    return indptr, cols


def no_plans():
    """Count DIA and chunk plan builds reached through the ops (a dynamic
    step must build none): returns the counter dict and an undo."""
    from torchsparsegradutils_tpu_torch.ops import logsumexp, spmm
    built = {"plans": 0}
    saved = []
    for mod, name in ((spmm, "build_dia_plan"), (spmm, "build_chunk_plan"),
                      (logsumexp, "build_dia_plan")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, **k):
            built["plans"] += 1
            return _fn(*a, **k)
        saved.append((mod, name, fn))
        setattr(mod, name, counted)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return built, undo


def new_pattern_host_cost(indptr, cols, values):
    """The static path's host work for one new pattern: the indices to
    the host, the ``StaticArray`` hashes, ``build_dia_plan``,
    ``build_chunk_plan`` and the transpose plan ``plan.T``; seconds of
    each on the card's host."""
    import torch
    from torchsparsegradutils_tpu_torch import SparseCSR
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        build_chunk_plan)
    from torchsparsegradutils_tpu_torch.kernels.dia import build_dia_plan
    out = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    ip, cl = indptr.cpu().numpy(), cols.cpu().numpy()
    out["to_host_s"] = time.perf_counter() - t
    t = time.perf_counter()
    A = SparseCSR(ip, cl, values, (N, N))
    rs, cs = A.row_sa(), A.col_sa()
    out["hash_s"] = time.perf_counter() - t
    t = time.perf_counter()
    build_dia_plan(rs, cs, N, N)
    out["dia_plan_s"] = time.perf_counter() - t
    t = time.perf_counter()
    plan = build_chunk_plan(rs, cs, N, N)
    out["chunk_plan_s"] = time.perf_counter() - t
    t = time.perf_counter()
    plan.T
    out["transpose_plan_s"] = time.perf_counter() - t
    out["total_s"] = sum(out.values())
    return out, A


def phase_dynamic(dev, card, R=None):
    """Phase 3h: device-resident patterns (``pattern_static=False``) at
    cfd2 width, float32 unless stated.

    *knn-dynamic*: at each step a new kNN-like pattern (N rows, 25
    columns a row) is drawn on the card and ``sparse_mm`` fwd+bwd at
    p = 128 and ``sddmm`` run on it as a dynamic CSR: zero host syncs
    (``torch.cuda.set_sync_debug_mode``), no plan built, no kernel
    launched; held against the same pattern as a static container on
    its default engine (K6, K7, K3) within ``1e-5·max|ref|``; times,
    beside the static path's host cost of each new pattern.  *dynamic
    tocsr*: a dynamic COO of phase 2's random pattern (``R``, its
    entries shuffled) to CSR, forward and backward: one K3 launch each,
    no plain version, bitwise the static ``coo_to_csr`` and K3's value
    permutations bitwise ``index_select`` by the host ``lexsort``'s
    permutation and its inverse, zero syncs.
    *dynamic LSE*: ``sparse_bidir_logsumexp`` fwd+bwd on ``R`` as a
    dynamic CSR against the static one, zero syncs; both routes' event
    and device times and profiles.  *dynamic solve*:
    ``sparse_generic_solve`` with CG in float64 on phase 3e's stencil
    SPD as a dynamic CSR against the static solve (K1): the same
    iterations, the solution within 1e-10 relative, residual <= 1e-4,
    host reads one every ``CHECK_EVERY`` steps.  *dynamic triangular*:
    the dense fallback at n = 4,096 with the JAX package's warning,
    residual <= 1e-5.  Prints one ``dynamic`` JSON line."""
    import warnings

    import numpy as np
    import torch
    from torchsparsegradutils_tpu_torch import (
        SparseCOO, SparseCSR, make_spd_stencil, sddmm, sparse_bidir_logsumexp,
        sparse_generic_solve, sparse_mm, sparse_triangular_solve)
    from torchsparsegradutils_tpu_torch import solvers as ps
    from torchsparsegradutils_tpu_torch.solvers import common
    from torchsparsegradutils_tpu_torch.utils import coo_to_csr
    from torchsparsegradutils_tpu_torch.utils.random_sparse import (
        rand_sparse, rand_sparse_tri)

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(19)
    cgen = torch.Generator(device=dev).manual_seed(19)
    if R is None:
        R = rand_sparse((N, N), NNZ_RANDOM, layout="csr", generator=gen,
                        device=dev)
    rec = {"card": card}
    everything = tuple(counters()) + tuple(PLAIN)

    # ---- knn-dynamic ---------------------------------------------------------
    vals = torch.randn(N * KNN_K, generator=gen).to(dev)
    B = torch.randn(N, P, generator=gen).to(dev)
    G = torch.randn(N, P, generator=gen).to(dev)

    def dyn_step(pattern=None):
        indptr, cols = knn_pattern(cgen) if pattern is None else pattern
        A = SparseCSR(indptr, cols, vals, (N, N), pattern_static=False)
        v = vals.clone().requires_grad_(True)
        b = B.clone().requires_grad_(True)
        out = sparse_mm(A.with_data(v), b)
        ga, gb = torch.autograd.grad(out, (v, b), G)
        return out, ga, gb, sddmm(A, G, B).values

    pattern = knn_pattern(cgen)
    syncs, (built, undo) = {}, no_plans()
    try:
        zero_counters()
        with syncs_seen(syncs):
            got = dyn_step(pattern)
        read_counters("knn-dynamic", (), everything)
    finally:
        undo()
    if syncs or built["plans"]:
        raise AssertionError(f"knn-dynamic: host syncs {syncs}, "
                             f"{built['plans']} plans built")
    host, S = new_pattern_host_cost(*pattern, vals)
    zero_counters()
    v = vals.clone().requires_grad_(True)
    b = B.clone().requires_grad_(True)
    out = sparse_mm(S.with_data(v), b)
    ref = (out, *torch.autograd.grad(out, (v, b), G),
           sddmm(S, G, B).values)
    static_launches = read_counters("knn-static", CHUNK_KERNELS)
    for name, g_, r_ in zip(("out", "gradA", "gradB", "sddmm"), got, ref):
        close(f"knn-dynamic {name} vs static", g_, r_, "float32")
    del got, ref, out
    step_event = time_ms(lambda: dyn_step(), reps=DYN_REPS)
    walls = []
    for _ in range(DYN_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dyn_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)

    def static_step():
        v_ = vals.clone().requires_grad_(True)
        b_ = B.clone().requires_grad_(True)
        o = sparse_mm(S.with_data(v_), b_)
        torch.autograd.grad(o, (v_, b_), G)
        sddmm(S, G, B)
    static_event = time_ms(static_step, reps=DYN_REPS)
    dev_ms = device_ms(lambda: dyn_step(), "", reps=5)
    profile_step("knn_dynamic", lambda: dyn_step(), steps=3, top=8)
    host2 = new_pattern_host_cost(*knn_pattern(cgen), vals)[0]
    rec["knn_dynamic"] = {
        "n": N, "k": KNN_K, "nnz": N * KNN_K, "p": P,
        "syncs": syncs, "plans_built": built["plans"],
        "step_event_ms": step_event, "step_wall_ms": walls,
        "step_device_ms": dev_ms, "static_step_event_ms": static_event,
        "static_launches": {k: c for k, c in static_launches.items() if c},
        "static_new_pattern_host_s": [host, host2]}
    print(f"  knn-dynamic: step event {step_event:.3f} ms, device "
          f"{dev_ms:.3f} ms, wall {min(walls):.2f}-{max(walls):.2f} ms; "
          f"static step {static_event:.3f} ms plus "
          f"{host['total_s']:.3f} / {host2['total_s']:.3f} s of host work "
          f"a new pattern {host}")
    del S, vals, B, G, pattern
    print(f"  3h knn-dynamic done at {time.perf_counter() - t0:.1f} s")

    # ---- dynamic tocsr -----------------------------------------------------
    perm = torch.randperm(R.nnz, generator=cgen, device=dev)
    rows_u, cols_u = R.rows_t()[perm].to(torch.int32), R.cols_t()[perm].to(
        torch.int32)
    vals_u = R.values[perm].contiguous()
    w = torch.randn(R.nnz, generator=gen).to(dev)
    D = SparseCOO(rows_u, cols_u, vals_u, (N, N), pattern_static=False)
    U = SparseCOO(rows_u.cpu().numpy(), cols_u.cpu().numpy(), vals_u,
                  (N, N))

    def to_csr(M):
        v_ = M.values.clone().requires_grad_(True)
        C = coo_to_csr(M.with_data(v_))
        return C, torch.autograd.grad((C.values * w).sum(), v_)[0]

    syncs = {}
    zero_counters()
    with syncs_seen(syncs):
        Cd, gd = to_csr(D)
    launches = read_counters("dynamic tocsr", ("gather",),
                             ("gather_plain",))
    if launches["gather"] != 2 or syncs:
        raise AssertionError(f"dynamic tocsr: {launches['gather']} K3 "
                             f"launches (want 2), host syncs {syncs}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    Cs, gs = to_csr(U)
    torch.cuda.synchronize()
    static_ms = (time.perf_counter() - t) * 1e3
    host = (torch.from_numpy(Cs.indptr_np().copy()),
            torch.from_numpy(Cs.cols().copy()))
    same = (torch.equal(Cd.indptr.cpu(), host[0])
            and torch.equal(Cd.indices.cpu(), host[1])
            and torch.equal(Cd.values, Cs.values) and torch.equal(gd, gs))
    # K3's value permutations against plain index_select by the host
    # lexsort's permutation and its inverse
    order = np.lexsort((cols_u.cpu().numpy(), rows_u.cpu().numpy()))
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    order, inv = (torch.from_numpy(a).to(dev) for a in (order, inv))
    plain = (torch.equal(Cd.values, vals_u.index_select(0, order))
             and torch.equal(gd, w.index_select(0, inv)))
    if not (same and plain):
        raise AssertionError(f"dynamic tocsr: bitwise the static coo_to_csr "
                             f"{same}, K3 equal to index_select {plain}")
    rec["dynamic_tocsr"] = {
        "nnz": R.nnz, "k3_launches": launches["gather"], "syncs": syncs,
        "bitwise": True,
        "event_ms": time_ms(lambda: to_csr(D), reps=DYN_REPS),
        "device_ms": device_ms(lambda: to_csr(D), "", reps=5),
        "static_wall_ms": static_ms}
    print(f"  dynamic tocsr: 2 K3 launches, bitwise the static coo_to_csr "
          f"and index_select by the host lexsort, "
          f"event {rec['dynamic_tocsr']['event_ms']:.3f} ms (static "
          f"{static_ms:.1f} ms wall with its host sort)")
    del D, U, Cd, Cs, gd, gs, perm, rows_u, cols_u, vals_u, w
    print(f"  3h dynamic tocsr done at {time.perf_counter() - t0:.1f} s")

    # ---- dynamic LSE ---------------------------------------------------------
    Rd = SparseCSR(R.indptr_t().to(torch.int32), R.cols_t().to(torch.int32),
                   R.values, R.shape, pattern_static=False)
    gc, gr = (torch.randn(N, generator=gen).to(dev) for _ in range(2))

    def lse(M):
        v_ = M.values.clone().requires_grad_(True)
        c, r = sparse_bidir_logsumexp(M.with_data(v_))
        return c, r, torch.autograd.grad((c * gc).sum() + (r * gr).sum(),
                                         v_)[0]

    syncs = {}
    zero_counters()
    with syncs_seen(syncs):
        got = lse(Rd)
    read_counters("dynamic LSE", (), everything)
    if syncs:
        raise AssertionError(f"dynamic LSE: host syncs {syncs}")
    ref = lse(R)
    close("dynamic LSE col vs static", got[0], ref[0], "float32", LSE_TOL)
    close("dynamic LSE row vs static", got[1], ref[1], "float32", LSE_TOL)
    close("dynamic LSE gradA vs static", got[2], ref[2], "float32",
          LSE_GRAD_TOL)
    rec["dynamic_lse"] = {
        "syncs": syncs, "event_ms": time_ms(lambda: lse(Rd), reps=DYN_REPS),
        "device_ms": device_ms(lambda: lse(Rd), "", reps=5),
        "static_event_ms": time_ms(lambda: lse(R), reps=DYN_REPS),
        "static_device_ms": device_ms(lambda: lse(R), "", reps=5)}
    print(f"  dynamic LSE: event {rec['dynamic_lse']['event_ms']:.3f} ms, "
          f"device {rec['dynamic_lse']['device_ms']:.3f} ms; static "
          f"{rec['dynamic_lse']['static_event_ms']:.3f} / "
          f"{rec['dynamic_lse']['static_device_ms']:.3f} ms")
    profile_step("lse_dynamic", lambda: lse(Rd), steps=3, top=8)
    profile_step("lse_static", lambda: lse(R), steps=3, top=8)
    del Rd, got, ref
    print(f"  3h dynamic LSE done at {time.perf_counter() - t0:.1f} s")

    # ---- dynamic solve (float64) ----------------------------------------------
    st = ps.LinearCGSettings(**SOLVE_ST)
    spd = {}
    for static in (True, False):
        spd[static] = make_spd_stencil(
            N, SPD_OFFSETS, layout="csr", dtype=torch.float64,
            generator=torch.Generator().manual_seed(20), device=dev,
            pattern_static=static)
    b = torch.randn(N, generator=gen, dtype=torch.float64).to(dev)
    solves = {}
    for static in (True, False):
        log = []
        solver = Recorder(ps.linear_cg, log)
        zero_counters()
        x = sparse_generic_solve(spd[static], b, solve=solver,
                                 transpose_solve=solver, settings=st)
        lc = read_counters(f"dynamic solve static={static}",
                           ("dia_spmm",) if static else (),
                           () if static else everything)
        solves[static] = (x, take(log)[0], lc)
    (xs, ls, _), (xd, ld, _) = solves[True], solves[False]
    relx = rel(xd, xs)
    res = rel(plain_mv(spd[False], xd), b)
    reads_cap = -(-ld["iterations"] // common.CHECK_EVERY) + 1
    if ld["iterations"] != ls["iterations"] or not relx <= 1e-10 \
            or not res <= SOLVE_RES or ld["reads"] > reads_cap:
        raise AssertionError(
            f"dynamic solve: iterations {ld['iterations']} vs static "
            f"{ls['iterations']}, solution {relx:.3e} off, residual "
            f"{res:.3e}, {ld['reads']} host reads (cap {reads_cap})")
    timing = solve_timing(lambda: sparse_generic_solve(
        spd[False], b, solve=ps.linear_cg, settings=st))
    rec["dynamic_solve"] = {
        "nnz": spd[False].nnz, "dtype": "float64",
        "iterations": ld["iterations"], "static_iterations": ls["iterations"],
        "reads": ld["reads"], "rel_solution": relx, "rel_residual": res,
        "timing": timing, "static_timing": solve_timing(
            lambda: sparse_generic_solve(spd[True], b, solve=ps.linear_cg,
                                         settings=st))}
    print(f"  dynamic solve: {ld['iterations']} CG iterations (static "
          f"{ls['iterations']}), solution {relx:.2e} off the static, "
          f"residual {res:.2e}, {ld['reads']} host reads, wall "
          f"{timing['wall_ms']:.1f} ms, device {timing['device_ms']:.2f} ms")
    del spd, solves, xs, xd
    print(f"  3h dynamic solve done at {time.perf_counter() - t0:.1f} s")

    # ---- dynamic triangular (the dense fallback) ------------------------------
    T = rand_sparse_tri((DYN_TRI_N, DYN_TRI_N), DYN_TRI_NNZ, generator=gen,
                        device=dev, pattern_static=False)
    bt = torch.randn(DYN_TRI_N, 2, generator=gen).to(dev)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        x = sparse_triangular_solve(T, bt, upper=False)
    said = [str(w_.message) for w_ in seen
            if issubclass(w_.category, UserWarning)
            and "densified" in str(w_.message)]
    res = rel(sparse_mm(T, x).double(), bt.double())
    if not said or not res <= 1e-5:
        raise AssertionError(f"dynamic triangular: warning {said}, "
                             f"residual {res:.3e}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tri_ms = time_ms(lambda: sparse_triangular_solve(T, bt, upper=False),
                         reps=5)
    rec["dynamic_triangular"] = {"n": DYN_TRI_N, "nnz": T.nnz,
                                 "warning": said[0], "rel_residual": res,
                                 "event_ms": tri_ms}
    print(f"  dynamic triangular n = {DYN_TRI_N}: warned, residual "
          f"{res:.2e}, {tri_ms:.2f} ms")
    rec["seconds"] = time.perf_counter() - t0
    print(f"card: {card}")
    print(json.dumps({"dynamic": rec}))
    return rec


def phase_only(phase) -> int:
    """``--solve`` / ``--models`` / ``--interop`` / ``--dynamic``: build
    the kernels and run one phase (3e, 3f, 3g or 3h) alone."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from torchsparsegradutils_tpu_torch.kernels import _build
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(f"card: {card}")
    info = _build.build()
    _build.libraries()
    print(f"kernels built in {info['seconds']:.1f} s")
    count_plain()
    phase(dev, card)
    return 0


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from torchsparsegradutils_tpu_torch import sparse_logsumexp, sparse_mm
    from torchsparsegradutils_tpu_torch.kernels import _build, dia
    from torchsparsegradutils_tpu_torch.kernels.chunk_lse import (
        lse_rows, lse_rows_bwd, lse_rows_bwd_plain, lse_rows_plain,
        plan_packs)
    from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (
        build_chunk_plan, chunk_bwd_cols, chunk_bwd_cols_plain, chunk_sddmm,
        chunk_sddmm_plain, chunk_spmm, chunk_spmm_plain, chunk_spmv,
        chunk_spmv_plain, SPMV_PACK)
    from torchsparsegradutils_tpu_torch.kernels.dia import (
        build_dia_plan, sddmm_core, sddmm_core_plain, spmm_core,
        spmm_core_plain, values_to_grid)
    from torchsparsegradutils_tpu_torch.kernels import dia_tri
    from torchsparsegradutils_tpu_torch.kernels.dia_tri import (
        tri_dia_core, tri_dia_core_plain, tri_dia_inv)
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
    S = lse_skewed(gen, dev)
    splan = build_chunk_plan(S.row_sa(), S.col_sa(), N, N)
    print(f"  lse-skewed: {S.nnz} entries, longest row "
          f"{int(np.diff(splan.indptr).max())}, built in "
          f"{time.perf_counter() - t1:.1f} s")
    lplan, lvals = lse_awkward_plan()
    H = hybrid_sparse((N, N), STENCIL_OFFSETS, NNZ_HYBRID, dia_coverage=0.85,
                      generator=gen, device=dev)
    hplan = build_dia_plan(H.row_sa(), H.col_sa(), N, N)
    rplan = dia._resid_chunk_plan(hplan)
    rvals = H.values[torch.from_numpy(hplan.resid_sel).to(dev)]
    e1 = check_k1(A, plan, grid, B, G, gen, dev)
    e3 = check_k2(A, plan, tplan, B, G, gen, dev)
    err = {}
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        name = str(dt).removeprefix("torch.")
        g, b, gg = grid.to(dt), B.to(dt), G.to(dt)
        vals = A.values.to(dt)
        for what, src, idx in (("values->grid", vals, maps["src_of_grid"]),
                               ("grid->values", g.reshape(-1), maps["pos"])):
            got = window_gather(src, idx)
            if not torch.equal(got, window_gather_plain(src, idx)):
                raise AssertionError(f"gather {what} [{name}] not exact")
            print(f"  gather {what} [{name}]: exact")
        ec = check_chunk_kernels("random cfd2", cplan, R.values.to(dt), b, gg,
                                 name)
        # K8 on the random pattern (A x and Aᵀ g), lse-skewed's rows and
        # its hubs alone, the hybrid85 residual and the small pattern
        x, xg = b[:, 0].contiguous(), gg[:, 0].contiguous()
        ec["chunk_spmv"] = check_k8("random cfd2", k8_calls(
            cplan, R.values.to(dt), x, xg), name)
        hubs = sub_rows(splan, np.diff(splan.indptr) > 256, S.values.to(dt),
                        dev)
        check_k8("lse-skewed cfd2", {
            **k8_calls(splan, S.values.to(dt), x, xg),
            "hubs alone A@x": (hubs[:3] + (x,), k8_table(hubs[3], dev))},
            name)
        check_k8("hybrid85 residual", k8_calls(rplan, rvals.to(dt), x, xg),
                 name)
        ec["chunk_spmm"] = max(ec["chunk_spmm"], check_k6_cases(
            cplan, rplan, R.values.to(dt), rvals.to(dt), b, gg, name, gen))
        ec["chunk_sddmm"] = max(ec["chunk_sddmm"], check_k7_cases(
            cplan, rplan, b, gg, name, gen))
        sv = torch.randn(small.nnz, generator=gen).to(dev, dt)
        sB = torch.randn(small.m, 3, generator=gen).to(dev, dt)
        sX = torch.randn(small.n, 3, generator=gen).to(dev, dt)
        check_chunk_kernels("small p=3", small, sv, sB, sX, name)
        check_k8("small", k8_calls(small, sv, sB[:, 0].contiguous(),
                                   sX[:, 0].contiguous()), name)
        d = small.maps(dev)
        if not bool((chunk_spmm(d["indptr"], d["cols"], sv, sB)[::7] == 0
                     ).all()):
            raise AssertionError("chunk_spmm: an empty row is not 0")
        if dt == torch.float32:
            err = {"dia_spmm": e1, "dia_sddmm": e3, "gather": 0.0, **ec}
        # the triangular kernel on the stencil's lower triangle, against
        # its plain version at the kernel's row block; its block inverses
        tg = tgrid.to(dt)
        tacc = torch.float64 if dt == torch.float64 else torch.float32
        tnb = dia_tri.KERNEL_NB
        for tb in (TB.to(dt), TB[:, :2].contiguous().to(dt)):
            got = tri_dia_core(tplan.offsets, tg, tb, unit=False)
            again = tri_dia_core(tplan.offsets, tg, tb, unit=False)
            if not torch.equal(got, again):
                raise AssertionError(f"tri_dia p={tb.shape[1]} [{name}]: "
                                     "two launches differ")
            e = close(f"tri_dia p={tb.shape[1]} nb={tnb} (repeats bitwise)",
                      got, tri_dia_core_plain(tplan.offsets, tg, tb,
                                              unit=False, nb=tnb), name)
            if dt == torch.float32:
                err["tri_dia"] = max(err.get("tri_dia", 0.0), e)
        inv = tri_dia_inv(tplan.offsets, tg, unit=False)
        if not torch.equal(inv, tri_dia_inv(tplan.offsets, tg, unit=False)):
            raise AssertionError(f"tri_dia_inv [{name}]: two launches "
                                 "differ")
        e = close(f"tri_dia_inv nb={tnb} (repeats bitwise)", inv,
                  dia_tri._build_diag_inv(tplan.offsets, tg, N,
                                          -(-N // tnb), tnb, False, tacc),
                  name)
        del inv
        if dt == torch.float32:
            err["tri_dia_inv"] = e
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
    count_plain()
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
    launches_h = drive("hybrid85 p=128", H, B, G,
                       DIA_KERNELS + ("chunk_spmm", "chunk_sddmm"))
    B16, G16 = B[:, :16].contiguous(), G[:, :16].contiguous()
    launches_16 = drive("stencil p=16", A, B16, G16, DIA_KERNELS)
    launches_r = drive("random p=128", R, B, G, CHUNK_KERNELS)
    B1, G1 = B[:, :1].contiguous(), G[:, :1].contiguous()
    launches_r1 = drive("random p=1", R, B1, G1,
                        ("chunk_spmv", "chunk_sddmm", "gather"))
    # (label, op, matrix, p, launches, routes) for explain, phase 3g
    seen = [("stencil p=128", "sparse_mm", A, P, launches, []),
            ("hybrid85 p=128", "sparse_mm", H, P, launches_h, []),
            ("stencil p=16", "sparse_mm", A, 16, launches_16, []),
            ("random p=128", "sparse_mm", R, P, launches_r, []),
            ("random p=1", "sparse_mm", R, 1, launches_r1, [])]
    if launches_r1["chunk_spmv"] != 2:       # A x, then Aᵀ g over plan.T
        raise AssertionError("random p=1: chunk_spmv launched "
                             f"{launches_r1['chunk_spmv']} times, not 2")
    C = torch.randn(R.nnz, generator=gen).to(dev)
    zero_counters()
    got = sddmm_fwd_bwd(R, G, B, C, "auto")
    seen.append(("random p=128", "sddmm", R, P, read_counters(
        "random sddmm p=128", CHUNK_KERNELS), []))
    for name, g_, r_ in zip(("values", "gradX", "gradY"), got,
                            sddmm_fwd_bwd(R, G, B, C, "xla")):
        close(f"random sddmm {name} vs generic path", g_, r_, "float32")
    CA = torch.randn(A.nnz, generator=gen).to(dev)
    zero_counters()
    got = sddmm_fwd_bwd(A, G, B, CA, "auto")
    seen.append(("stencil p=128", "sddmm", A, P, read_counters(
        "stencil sddmm p=128", DIA_KERNELS), []))
    for name, g_, r_ in zip(("values", "gradX", "gradY"), got,
                            sddmm_fwd_bwd(A, G, B, CA, "xla")):
        close(f"stencil sddmm {name} vs generic path", g_, r_, "float32")

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
    launches_t, routes_t = drive_tri("tri-stencil p=128", T, TB, GT,
                                     TRI_KERNELS, ref_algorithm="block",
                                     upper=False)
    seen.append(("tri-stencil p=128", "triangular_solve", T, P, launches_t,
                 routes_t))
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
    seen.append(("tri-random p=2", "triangular_solve", TR, 2, launches_tr,
                 routes_tr))

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
    seen += [("lse-stencil", "sparse_logsumexp", A, P, drive_lse(
        "lse-stencil", A, ("gather",), LSE_CHUNK), []),
        ("lse-random", "sparse_logsumexp", R, P, drive_lse(
            "lse-random", R, ("gather",), LSE_CHUNK), [])]
    launches_lse = drive_lse("lse-skewed", S, LSE_CHUNK + ("gather",), ())
    seen.append(("lse-skewed", "sparse_logsumexp", S, P, launches_lse, []))
    split, mem_split = peak_extra(lambda: fwd_bwd(R, B, G, "auto"))
    peak_mib = {"split": mem_split}
    dia.SPMM_BWD = "fused"
    try:
        for gp in ("exact", "fast"):
            zero_counters()
            got, peak_mib[f"fused_{gp}"] = peak_extra(
                lambda: fwd_bwd(R, B, G, "auto", grad_precision=gp))
            lf = read_counters(f"random-fused p=128 {gp}", FUSED,
                               ("chunk_sddmm", "chunk_sddmm_plain"))
            if lf["chunk_spmm"] != 1 or lf["chunk_bwd_cols"] != 1:
                raise AssertionError(
                    f"random-fused: chunk_spmm launched {lf['chunk_spmm']} "
                    f"times and chunk_bwd_cols {lf['chunk_bwd_cols']}, not "
                    "once each (the forward, the backward)")
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
    print(json.dumps({"random_fused_fwd_bwd_peak_extra_mib": peak_mib,
                      "card": card}))

    print(f"phase 3d: parallel/ on a one-rank NCCL group "
          f"({time.perf_counter() - t0:.1f} s in)")
    k13_row = phase_parallel(R, A, B, G, gen, dev, card)
    print(f"phase 3e: sparse_generic_solve / sparse_generic_lstsq over the "
          f"Krylov solvers ({time.perf_counter() - t0:.1f} s in)")
    phase_solvers(dev, card)
    print(f"phase 3f: the sparse multivariate normals at the flagship's "
          f"width ({time.perf_counter() - t0:.1f} s in)")
    phase_models(dev, card)
    print(f"phase 3g: the ELL engine, distributed solves, interop and "
          f"explain ({time.perf_counter() - t0:.1f} s in)")
    phase_interop(dev, card, seen, {"stencil": A, "random": R,
                                    "hybrid85": H, "B": B, "G": G})
    del seen
    print(f"phase 3h: device-resident (dynamic) patterns "
          f"({time.perf_counter() - t0:.1f} s in)")
    dynamic = phase_dynamic(dev, card, R)

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
    k2 = k2_times(A, plan, B, G, dev)
    print(json.dumps({"k2_times": k2, "card": card}))
    k6 = k6_times(R, cplan, H, B, G, dev)
    print(json.dumps({"k6_times": k6, "card": card}))
    k7 = k7_times(R, cplan, H, B, G, dev)
    print(json.dumps({"k7_times": k7, "card": card}))
    k9 = k9_times(T, tplan, tgrid, TB, GT, dev)
    print(json.dumps({"k9_times": k9, "card": card}))
    k8 = k8_times(R, cplan, S, H, dev, probes=False)
    print(json.dumps({"k8_times": k8, "card": card}))
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
    rpk = plan_packs(cplan, dev, SPMV_PACK)
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
         lambda: sddmm_core(offs, G, B, plan.geo),
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
         lambda: chunk_spmv(cm["indptr"], cm["cols"], R.values, x1, rpk),
         lambda: chunk_spmv_plain(cm["indptr"], cm["cols"], R.values, x1),
         lambda: torch.sparse.mm(csr_r, B1),
         bound(nnz_r * es + idx_bytes + (ucols + n) * es, 2 * nnz_r)),
    ]
    Kt = tplan.K
    tcells = valid_cells(tplan.offsets.tolist(), n, n)
    tcsr = torch.sparse_csr_tensor(
        torch.from_numpy(T.indptr_np().astype("int64")).to(dev),
        T.cols_t(), T.values, (n, n))
    tnb = dia_tri.KERNEL_NB
    tnblk = -(-n // tnb)
    in_block = [o for o in tplan.offsets.tolist() if -tnb < o <= 0]
    spec += [
        ("tri_dia", "torchsparsegradutils_tpu_torch/csrc/tri_dia.cu",
         "torchsparsegradutils_tpu/kernels/dia_tri.py:150 (K9 "
         "tri_dia_core)", launches_t,
         lambda: tri_dia_core(tplan.offsets, tgrid, TB, unit=False),
         lambda: tri_dia_core_plain(tplan.offsets, tgrid, TB, unit=False,
                                    nb=tnb),
         lambda: torch.triangular_solve(TB, tcsr, upper=False),
         bound((n * Kt + 2 * n * P) * es, 2 * tcells * P)),
        # the block inverses: the grid's in-block columns read, Dinv
        # written; forward substitution, nb - c rows of each column c
        ("tri_dia_inv", "torchsparsegradutils_tpu_torch/csrc/tri_dia.cu",
         "torchsparsegradutils_tpu/kernels/dia_tri.py:50 (K9's block "
         "inverses, _build_diag_inv)", launches_t,
         lambda: tri_dia_inv(tplan.offsets, tgrid, unit=False),
         lambda: dia_tri._build_diag_inv(tplan.offsets, tgrid, n, tnblk,
                                         tnb, False, torch.float32),
         None, bound((n * len(in_block) + tnblk * tnb * tnb) * es,
                     tnblk * tnb * (tnb + 1) // 2
                     * (2 * (len(in_block) - 1) + 1)))]
    # K10 and K11 on lse-skewed (include_zeros, as sparse_logsumexp's
    # default), K12 on the random pattern at p = 128
    sm = splan.maps(dev)
    spk = plan_packs(splan, dev)
    nnz_s = S.nnz
    out_s = lse_rows(sm["indptr"], S.values, N, True, spk)
    g_s = torch.randn(N, generator=gen).to(dev)
    coo_s = torch.sparse_coo_tensor(torch.stack([S.rows_t(), S.cols_t()]),
                                    S.values, (N, N)).coalesce()
    ctm = cplan.T.maps(dev)
    k12_args = (ctm["indptr"], ctm["cols"], ctm["perm"], ctm["inv"],
                R.values, B, G)
    csr_rt = torch.sparse_csr_tensor(ctm["indptr"], ctm["cols"],
                                     R.values[ctm["perm"]], (m, n))
    lse_src = "torchsparsegradutils_tpu_torch/csrc/chunk_lse.cu"
    fused_src = "torchsparsegradutils_tpu_torch/csrc/chunk_bwd_fused.cu"
    spec += [
        ("lse_rows", lse_src, "torchsparsegradutils_tpu/kernels/"
         "chunk_lse.py:70 (K10 _lse_partials)", launches_lse,
         lambda: lse_rows(sm["indptr"], S.values, N, True, spk),
         lambda: lse_rows_plain(sm["indptr"], S.values, N, True),
         lambda: torch.sparse.log_softmax(coo_s, 1),
         bound(nnz_s * es + (n + 1) * 8 + n * es, 2 * nnz_s)),
        ("lse_rows_bwd", lse_src, "torchsparsegradutils_tpu/kernels/"
         "chunk_lse.py:142 (K11 _lse_bwd_pass)", launches_lse,
         lambda: lse_rows_bwd(sm["indptr"], S.values, out_s, g_s, spk),
         lambda: lse_rows_bwd_plain(sm["indptr"], S.values, out_s, g_s),
         None, bound(2 * nnz_s * es + (n + 1) * 8 + 2 * n * es,
                     2 * nnz_s)),
        # G's and B's read rows, dB written, vals and dd, cols_t and perm
        # (int64), indptr_t; a dot's FMA, a product and an add a column
        ("chunk_bwd_cols", fused_src, "torchsparsegradutils_tpu/kernels/"
         "chunk_spmm.py:429 and :462 (K12a and K12b, chunk_spmm_bwd_fused's "
         "two passes)", launches_f,
         lambda: chunk_bwd_cols(*k12_args),
         lambda: chunk_bwd_cols_plain(*k12_args), None,
         bound((urows + ucols + m) * P * es + 2 * nnz_r * es
               + 2 * nnz_r * 8 + (m + 1) * 8, 4 * nnz_r * P)),
    ]
    for name, source, replaces, lc, kern, plain, lib, (b_ms, b_by) in spec:
        reps = 5 if name == "tri_dia" else 20
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": lc[name],
            "max_abs_err": err[name], "ms": time_ms(kern, reps=reps),
            "plain_ms": time_ms(plain, reps=reps), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}
        if lib is None and name == "tri_dia_inv":
            row["library_note"] = (
                "no single PyTorch call builds the block inverses from the "
                "grid; torch.linalg.solve_triangular on the built blocks "
                "is library_solve_ms")
            D = torch.linalg.inv(dia_tri._build_diag_inv(
                tplan.offsets, tgrid, n, tnblk, tnb, False, torch.float32))
            eye = torch.eye(tnb, device=dev).expand(tnblk, tnb, tnb)
            row["library_solve_ms"] = time_ms(
                lambda: torch.linalg.solve_triangular(D, eye, upper=False))
            row["device_ms"] = device_ms(kern, "tri_dia_inv")
            del D
        elif name == "chunk_bwd_cols":
            # no one call gives both gradients: gradA's and gradB's library
            # calls, each alone and both in turn
            row["library_note"] = (
                "no single PyTorch call computes (gradA, gradB); "
                "torch.sparse.sampled_addmm gives gradA, torch.sparse.mm "
                "on A^T gradB")
            gA = lambda: torch.sparse.sampled_addmm(csr_r, G, B.t(),
                                                    beta=0.0)
            gB = lambda: torch.sparse.mm(csr_rt, G)
            row["library_sampled_addmm_ms"] = time_ms(gA)
            row["library_sparse_mm_t_ms"] = time_ms(gB)
            row["library_pair_ms"] = time_ms(lambda: (gA(), gB()))
            row["device_ms"] = device_ms(kern, "bwd_cols")
            # with its two K3 gathers (values in, dd out)
            row["device_ms_with_gathers"] = device_ms(kern, "")
        elif lib is None:
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
        if name == "dia_sddmm":
            row["per_launch"] = k2
        if name == "chunk_spmm":
            row["per_launch"] = k6
        if name == "chunk_sddmm":
            row["per_launch"] = k7
        if name == "tri_dia":
            row["per_launch"] = k9
        if name == "chunk_spmv":
            # the event times of K8 and the library call are the host's
            # pace: their profiled device times
            row["per_launch"] = k8
            row["device_ms"] = device_ms(kern, "chunk_spmv_kernel")
            row["library_device_ms"] = device_ms(lib, "")
        if name in ("lse_rows", "lse_rows_bwd"):
            # the event time of a launch this short is the host's pace
            row["device_ms"] = device_ms(kern, f"{name}_kernel")
        if name == "gather":
            # K3's event time is near the host's launch rate: the profiled
            # kernel time of K3 and of the library call
            row["device_ms"] = device_ms(kern, "gather_kernel")
            row["dynamic_tocsr_launches"] = dynamic["dynamic_tocsr"][
                "k3_launches"]
            row["library_device_ms"] = device_ms(lib, "")
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
    mode = {"--k1": "k1", "--k2": "k2", "--k6": "k6", "--k7": "k7",
            "--k8": "k8", "--k9": "k9", "--k10": "k10"}.get(
                " ".join(sys.argv[1:]))
    only = {"--solve": phase_solvers, "--models": phase_models,
            "--interop": phase_interop, "--dynamic": phase_dynamic}
    if len(sys.argv) == 2 and sys.argv[1] in only:
        rc = phase_only(only[sys.argv[1]])
    else:
        rc = compare(mode) if mode else main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
