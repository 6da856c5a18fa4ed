"""The bytes and FLOPs of count/ against hand sums at a small size, and
the roofline reader on a trace whose kernels run at their least time."""

import pytest

import portbench_helpers  # noqa: F401  (puts the repository on sys.path)

from portbench import count, trace


def test_op_counts_by_hand():
    # A (4, 3) with 5 entries, p = 2, float32, int32 indices
    assert count.spmm(4, 3, 5, 2) == (5 * 4 + (5 + 5) * 4 + (3 + 4) * 2 * 4,
                                      2 * 5 * 2)
    assert count.spmm(4, 3, 5, 2, indexed=False) == (20 + 56, 20)
    assert count.sddmm(4, 3, 5, 2) == ((4 + 3) * 2 * 4 + 5 * 4 + 10 * 4, 20)
    assert count.trisolve(4, 7, 2) == (7 * 4 + 2 * 4 * 2 * 4,
                                       (2 * 3 + 4) * 2)
    assert count.gather(10) == (10 * 12, 0)
    assert count.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert count.least_s(0, 67e12) == pytest.approx(1.0)


def test_step_counts_by_hand():
    s = {"op": "sparse_mm", "pattern": "static", "dtype": "float32",
         "n": 4, "m": 3, "nnz": 5, "p": 2}
    # reads values, B, G; writes out, gradA, gradB
    assert count.step(s) == (5 * 4 + 3 * 2 * 4 + 4 * 2 * 4 + 4 * 2 * 4
                             + 5 * 4 + 3 * 2 * 4, 3 * 2 * 5 * 2)
    d = dict(s, pattern="dynamic")
    assert count.step(d)[0] == count.step(s)[0] + (5 + 4 + 1) * 4
    t = dict(s, op="sparse_triangular_solve", m=4, nnz=7)
    assert count.step(t) == (2 * 7 * 4 + 4 * 4 * 2 * 4,
                             2 * (2 * 3 + 4) * 2 + 2 * 7 * 2)


def _ctx(kernels, steps=2, shape=None):
    shape = shape or {"op": "sparse_mm", "pattern": "static",
                      "dtype": "float32", "n": 1000, "m": 1000,
                      "nnz": 9000, "p": 64}
    return {"trace": {"steps": steps, "kernels": kernels}, "shape": shape}


def test_roofline_is_100_at_the_least_time_and_silent_without_a_kernel():
    ctx = _ctx({})
    s = ctx["shape"]
    spmm = count.least_s(*count.spmm(1000, 1000, 9000, 64, indexed=False))
    sddmm = count.least_s(*count.sddmm(1000, 1000, 9000, 64,
                                       indexed=False))
    ctx["trace"]["kernels"] = {
        "void (anonymous namespace)::dia_spmm_kernel<float, 4>(float*)":
            [4, 4 * spmm],
        "void (anonymous namespace)::dia_sddmm_kernel<float>(float*)":
            [2, 2 * sddmm]}
    assert trace.roofline(ctx, ("dia_spmm_kernel", "dia_sddmm_kernel")) \
        == pytest.approx(100.0)
    assert trace.roofline(ctx, ("dia_spmm_kernel", "tri_dia_kernel")) \
        is None
    # a launch that is part of another function's work adds time only
    ctx["trace"]["kernels"]["void tri_dia_inv_kernel<float>()"] = [2, 1.0]
    ctx["trace"]["kernels"]["void tri_dia_kernel<float, true>()"] = [2, 1.0]
    tri = count.least_s(*count.trisolve(s["n"], s["nnz"], s["p"]))
    assert trace.roofline(ctx, ("tri_dia_kernel",),
                          ("tri_dia_inv_kernel",)) \
        == pytest.approx(100.0 * 2 * tri / 2.0)
