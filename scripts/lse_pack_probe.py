"""Probe of the chunk LSE kernels' pack size T and lane groups G on the
card (K10 and K11, ``torchsparsegradutils_tpu_torch/csrc/chunk_lse.cu``).

The kernels take one pack size, ``PACK`` (``csrc/row_packs.cuh``;
``kernels/row_packs.py``: ``PACK_ENTRIES``), and the lane group of each
pack from the host's plan.  This script builds scratch copies of
``csrc/`` with ``PACK`` set to 1,024, 2,048 and 4,096 (under
``build/lse_pack_probe/``, one ``nvcc`` each, all at once), plans
lse-skewed's rows and the random pattern's rows at cfd2 scale
(``chip_smoke.py``'s shapes) with ``lse_packs`` at each T, checks each
build once against the plain version, and times K10 (``include_zeros``)
and K11 per launch by ``torch.profiler``: at each T with the plan's lane
groups, and at the committed T with G fixed at 4, 8, 16 and 32 for every
pack of several rows.  The sweep runs ``turns`` times in turn; prints
one JSON line with the card's name and power limit.

    python3 scripts/lse_pack_probe.py [turns]

Needs a CUDA device and ``nvcc``; float32 only.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from torchsparsegradutils_tpu_torch.kernels import (  # noqa: E402
    _build, chunk_lse)
from torchsparsegradutils_tpu_torch.kernels.chunk_spmm import (  # noqa
    build_chunk_plan)
from torchsparsegradutils_tpu_torch.utils.random_sparse import (  # noqa
    rand_sparse)

SIZES = (1024, 2048, 4096)
LANES = (4, 8, 16, 32)
LINE = f"constexpr int PACK = {chunk_lse.PACK_ENTRIES};"


def build(out_root):
    """``{T: ctypes.CDLL}`` of ``chunk_lse.cu`` built at each pack size
    (``PACK`` in ``row_packs.cuh``), without its float64 entries (above
    48 KB of shared memory at 4,096)."""
    packs = (_build.CSRC / "row_packs.cuh").read_text()
    assert packs.count(LINE) == 1, f"{LINE!r} not found in row_packs.cuh"
    src = (_build.CSRC / "chunk_lse.cu").read_text()
    src, k = re.subn(r"\nint tsgu_\w+_f64\(.*?\n}\n", "\n", src,
                     flags=re.S)
    assert k == 2, "chunk_lse.cu's float64 entries not found"
    procs = {}
    for T in SIZES:
        d = out_root / f"T{T}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        (d / "chunk_lse.cu").write_text(src)
        (d / "row_packs.cuh").write_text(
            packs.replace(LINE, f"constexpr int PACK = {T};"))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
               str(d / "libchunk_lse.so"), str(d / "chunk_lse.cu")]
        procs[T] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    libs = {}
    for T, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc at T = {T} failed:\n{log}")
        libs[T] = ctypes.CDLL(str(out_root / f"T{T}" / "libchunk_lse.so"))
    return libs


def table(indptr, T, lanes, dev):
    """The kernels' pack table at pack size ``T``: the plan's lane
    groups, or ``lanes`` for every pack of several rows."""
    starts = chunk_lse.lse_packs(indptr, T)
    G = chunk_lse.pack_lanes(indptr, starts)
    if lanes is not None:
        G = np.where(np.diff(starts) == 1, 32, lanes)
    t = np.zeros((len(starts), 3), dtype=np.int64)
    t[:, 0], t[:, 1] = starts, indptr[starts]
    t[:-1, 2] = np.log2(G).astype(np.int64)
    return torch.from_numpy(t).to(dev)


def call(lib, entry, *args):
    """C entry ``entry`` of ``lib`` on the current stream (tensors by
    data pointer, ints as int64); raises on a CUDA error."""
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    c = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
         else ctypes.c_int64(a) for a in args]
    rc = fn(*c, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


def main() -> int:
    if not torch.cuda.is_available():
        print("lse_pack_probe: no CUDA device", file=sys.stderr)
        return 1
    turns = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    dev = torch.device("cuda", 0)
    card = cs.smi_line()
    libs = build(ROOT / "build" / "lse_pack_probe")
    gen = torch.Generator().manual_seed(0)
    S = cs.lse_skewed(gen, dev)
    R = rand_sparse((cs.N, cs.N), cs.NNZ_RANDOM, layout="csr",
                    generator=gen, device=dev)
    configs = [(T, None) for T in SIZES] + [
        (chunk_lse.PACK_ENTRIES, G) for G in LANES]
    cases = []
    for label, M in (("skewed", S), ("random", R)):
        plan = build_chunk_plan(M.row_sa(), M.col_sa(), cs.N, cs.N)
        ip = plan.maps(dev)["indptr"]
        v = M.values.contiguous()
        g = torch.randn(plan.n, generator=gen).to(dev)
        ref = chunk_lse.lse_rows_plain(ip, v.double(), plan.m, True)
        dref = chunk_lse.lse_rows_bwd_plain(ip, v.double(), ref, g.double())
        for T, lanes in configs:
            pk = table(plan.indptr, T, lanes, dev)
            npk = pk.shape[0] - 1
            out = torch.empty(plan.n, device=dev)
            d = torch.empty_like(v)

            def fwd(lib=libs[T], a=(ip, v, pk, out, npk, plan.m, 1)):
                call(lib, "tsgu_lse_rows_f32", *a)

            def bwd(lib=libs[T], a=(ip, v, pk, out, g, d, npk)):
                call(lib, "tsgu_lse_rows_bwd_f32", *a)
            fwd()
            bwd()
            torch.cuda.synchronize()
            cs.close_inf(f"{label} T={T} G={lanes or 'plan'} K10", out, ref,
                         "float32")
            cs.close(f"{label} T={T} G={lanes or 'plan'} K11", d, dref,
                     "float32")
            cases.append((f"{label}_T{T}_G{lanes or 'plan'}", npk, fwd, bwd))
    res = {name: {"packs": npk, "k10_device_ms": [], "k11_device_ms": []}
           for name, npk, _, _ in cases}
    for _ in range(turns):
        for name, _, fwd, bwd in cases:
            res[name]["k10_device_ms"].append(
                cs.device_ms(fwd, "lse_rows_kernel"))
            res[name]["k11_device_ms"].append(
                cs.device_ms(bwd, "lse_rows_bwd_kernel"))
    print(json.dumps({"lse_pack_probe": res, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
