"""What the benchmark loads: nothing of JAX or the JAX package anywhere,
and nothing of the port in the references."""

import subprocess
import sys

from portbench_helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "torchsparsegradutils_tpu"}
LOADED = ("import sys, runpy, importlib, pkgutil\n"
          "sys.path.insert(0, {root!r})\n"
          "{body}\n"
          "print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))")


def _top_level_after(body):
    out = subprocess.run([sys.executable, "-c",
                          LOADED.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=300)
    return set(out.stdout.split())


def test_run_and_every_module_it_loads_import_no_jax():
    body = ("runpy.run_path({run!r}, run_name='portbench_run')\n"
            "import portbench, portbench.harness, portbench.control, "
            "portbench.faults\n"
            "for pkg in ('metrics', 'patterns', 'reference', 'count'):\n"
            "    p = importlib.import_module('portbench.' + pkg)\n"
            "    for m in pkgutil.iter_modules(p.__path__):\n"
            "        importlib.import_module(p.__name__ + '.' + m.name)\n"
            ).format(run=str(ROOT / "portbench" / "run.py"))
    loaded = _top_level_after(body)
    assert "torchsparsegradutils_tpu_torch" in loaded     # the port itself
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_references_load_nothing_of_the_port():
    body = ("import portbench.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module(r.__name__ + '.' + m.name)\n")
    loaded = _top_level_after(body)
    assert "torch" in loaded
    assert not loaded & (FORBIDDEN | {"torchsparsegradutils_tpu_torch"})
