"""Probe of the fused chunk backward's design choices on the card (K12,
``torchsparsegradutils_tpu_torch/csrc/chunk_bwd_fused.cu``).

Builds scratch copies of ``chunk_bwd_fused.cu`` under
``build/fused_bwd_probe/`` (one ``nvcc`` each, all at once), each with
one edit of the committed source:

* ``free``: no minimum of blocks an SM in ``__launch_bounds__`` (the
  compiler picks the registers), ``b3``, ``b5``: a minimum of 3 or 5
  blocks of 8 warps, not 4 (at most 85 or 51 registers a thread);
* ``u2``, ``u8``: 2 or 8 rounds of G loads in flight a lane, not 4;
* ``nb``: a block for every 8 columns, not the blocks that fit at once
  (each warp then takes one column, slab by slab);
* ``pass``: as ``nb``, but one launch a slab, in stream order, as K7
  runs its passes;

and ``+``-joined combinations of them; and, as a diagnostic whose
results need not agree, ``nodb`` (no dB sums:
the dd walk alone).  Each variant runs once at the uniform random cfd2
shape (n = m = 123,440, 3,087,898 entries, p = 128, float32, the
random-fused step's shape) and must give the committed kernel's dd and
dB bitwise.  Then every variant's launch is timed by ``torch.profiler``
(device time of the kernels whose name holds ``bwd_cols``) at p = 128
and at p = 64 (one slab), ``turns`` times in turn, beside the committed
kernel with the gathered rows of G folded into its first n / 4 rows
(15.8 MB, which the L2 holds: ``folded``), the wrapper's K3 gathers
(values into column order, dd back), K7 (``chunk_sddmm``, gradA alone;
also over the transpose plan, the dots in column order) and K6 over the
transpose plan (``chunk_spmm``, gradB alone).  Prints
the registers ptxas reports for each build's float32 vector kernel and
one JSON line with the card's name and power limit.

    python3 scripts/fused_bwd_probe.py [turns]

Needs a CUDA device and ``nvcc``.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from torchsparsegradutils_tpu_torch.kernels import (  # noqa: E402
    _build, chunk_spmm)
from torchsparsegradutils_tpu_torch.kernels.window_gather import (  # noqa
    window_gather)
from torchsparsegradutils_tpu_torch.utils.random_sparse import (  # noqa
    rand_sparse)

BOUNDS = "__launch_bounds__(WARPS * 32, BLOCKS)"
EDITS = {
    "free": [(BOUNDS, "__launch_bounds__(WARPS * 32)")],
    "b3": [("constexpr int BLOCKS = 4;", "constexpr int BLOCKS = 3;")],
    "b5": [("constexpr int BLOCKS = 4;", "constexpr int BLOCKS = 5;")],
    "u2": [("constexpr int U = 4;", "constexpr int U = 2;")],
    "u8": [("constexpr int U = 4;", "constexpr int U = 8;")],
    "nb": [("kernel<<<(unsigned)(need < fit ? need : fit),",
            "kernel<<<(unsigned)need,")],
    # one launch a slab, in stream order, as K7's passes (the pass rides
    # in lg's upper bits)
    "pass": [("  const int lane = threadIdx.x & 31;\n  const int64_t w0",
              "  const int pass = lg >> 8;\n  lg &= 255;\n"
              "  const int lane = threadIdx.x & 31;\n  const int64_t w0"),
             ("for (int64_t s = 0; s < slabs; ++s) {",
              "for (int64_t s = pass; s == pass; ++s) {"),
             ("kernel<<<(unsigned)(need < fit ? need : fit),",
              "kernel<<<(unsigned)need,")],
    "nodb": [("          for (int w = 0; w < W; ++w) acc[w] += "
              "product<RT>(v, g[w]);", "")],
}
VARIANTS = ("committed", "free", "b3", "b5", "u2", "u8", "nb", "pass",
            "pass+free", "nodb")
DIAGNOSTIC = ("nodb",)   # variants whose results are not the kernel's
ENTRY = "tsgu_chunk_bwd_cols_f32_f32_vec"


def source(variant):
    """The committed source with the edits of each ``+``-joined name."""
    src = (_build.CSRC / "chunk_bwd_fused.cu").read_text()
    for name in variant.split("+"):
        for old, new in EDITS.get(name, ()):
            assert src.count(old) == 1, f"{variant}: {old!r} not found once"
            src = src.replace(old, new)
    return src


def build(out_root):
    """``{variant: (ctypes.CDLL, registers)}``, one nvcc each."""
    procs = {}
    for v in VARIANTS:
        d = out_root / v.replace("+", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        (d / "chunk_bwd_fused.cu").write_text(source(v))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
               str(d / "lib.so"), str(d / "chunk_bwd_fused.cu")]
        procs[v] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc for {v} failed:\n{log}")
        # ptxas reports each kernel after its "Compiling entry" line
        regs = re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) "
                          r"registers", log, flags=re.S)
        libs[v] = (ctypes.CDLL(str(d / "lib.so")),
                   [int(r) for k, r in regs if "bwd_cols_kernelIffLb1" in k])
    return libs


def call(lib, entry, *args):
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    c = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
         else ctypes.c_int64(a) for a in args]
    rc = fn(*c, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    turns = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    dev = torch.device("cuda", 0)
    card = cs.smi_line()
    libs = build(ROOT / "build" / "fused_bwd_probe")
    gen = torch.Generator().manual_seed(0)
    R = rand_sparse((cs.N, cs.N), cs.NNZ_RANDOM, layout="csr", generator=gen,
                    device=dev)
    B = torch.randn(cs.N, cs.P, generator=gen).to(dev)
    G = torch.randn(cs.N, cs.P, generator=gen).to(dev)
    plan = chunk_spmm.build_chunk_plan(R.row_sa(), R.col_sa(), cs.N, cs.N)
    d, dt = plan.maps(dev), plan.T.maps(dev)
    vals = R.values.contiguous()
    vals_t = window_gather(vals, dt["perm"])
    nnz, m = vals.shape[0], plan.m
    ref_dd, ref_dB = chunk_spmm.chunk_bwd_cols(
        dt["indptr"], dt["cols"], dt["perm"], dt["inv"], vals, B, G)
    fold_cols = dt["cols"] % (cs.N // 4)
    B64, G64 = B[:, :64].contiguous(), G[:, :64].contiguous()
    dd_t = torch.empty_like(vals)

    def runner(lib, p, cols=dt["cols"], name=""):
        Bp, Gp = (B, G) if p == cs.P else (B64, G64)
        _, lg, _, _ = chunk_spmm.sddmm_passes(p, torch.float32, True, nnz,
                                              cs.N)
        dB = torch.empty_like(Bp)

        passes = -(-p // (4 << lg)) if "pass" in name else 1

        def run():
            for s in range(passes):
                call(lib, ENTRY, dt["indptr"], cols, vals_t, Bp, Gp, dd_t,
                     dB, m, p, lg | s << 8)
            return dd_t, dB
        return run
    runs = {}
    for v, (lib, _) in libs.items():
        runs[v] = (runner(lib, cs.P, name=v), runner(lib, 64, name=v))
        dd, dB = runs[v][0]()
        torch.cuda.synchronize()
        if v not in DIAGNOSTIC and not (
                torch.equal(window_gather(dd, dt["inv"]), ref_dd)
                and torch.equal(dB, ref_dB)):
            raise AssertionError(f"{v}: dd or dB differs from the committed "
                                 "kernel's")
    res = {v: {"registers": libs[v][1], "p128_device_ms": [],
               "p64_device_ms": []} for v in VARIANTS}
    extra = {
        "folded_p128": runner(libs["committed"][0], cs.P, fold_cols),
        "k3_values_in": lambda: window_gather(vals, dt["perm"]),
        "k3_dd_out": lambda: window_gather(dd_t, dt["inv"]),
        "k7_chunk_sddmm_p128": lambda: chunk_spmm.chunk_sddmm(
            d["indptr"], d["cols"], G, B),
        "k7_on_transpose_p128": lambda: chunk_spmm.chunk_sddmm(
            dt["indptr"], dt["cols"], B, G),
        "k7_chunk_sddmm_p64": lambda: chunk_spmm.chunk_sddmm(
            d["indptr"], d["cols"], G64, B64),
        "k6_chunk_spmm_t_p128": lambda: chunk_spmm.chunk_spmm(
            dt["indptr"], dt["cols"], vals_t, G)}
    for k in extra:
        res[k] = {"device_ms": []}
    for _ in range(turns):
        for v, (r128, r64) in runs.items():
            res[v]["p128_device_ms"].append(cs.device_ms(r128, "bwd_cols"))
            res[v]["p64_device_ms"].append(cs.device_ms(r64, "bwd_cols"))
        for k, fn in extra.items():
            res[k]["device_ms"].append(cs.device_ms(fn, ""))
    print(json.dumps({"fused_bwd_probe": res, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
