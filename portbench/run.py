#!/usr/bin/env python3
"""Run one cell of the benchmark on one NVIDIA card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared, beside its limit); the numbers compared are also
the last lines of standard error.  With no CUDA card, too few cards, or
JAX or the JAX package loaded, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # bytecode of every module this run imports, cached at a fixed path in
    # the checkout: a read-only site-packages would otherwise be compiled
    # again by every run
    sys.pycache_prefix = str(ROOT / "build" / "portbench" / "pycache")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in CACHES.items():   # fixed paths inside the checkout
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    spec = harness.load(ROOT, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.say(f"{args.workload} needs {chips} CUDA card(s); "
                    f"torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}, device_count() is "
                    f"{torch.cuda.device_count()}")
        return 2
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    result = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        harness.say(f"loaded modules that the benchmark may not load: "
                    f"{found}")
        return 3
    for line in harness.check_lines(result):
        harness.say(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
