#!/usr/bin/env python3
"""Read the numbers that ``correct`` compares, for a cell's limits.

    python3 portbench/control.py --workload <cell> [--seeds 12] \
        [--controls 3] [--out <file.json>]

On the card, at the cell's own size, with no measured window: the
program on ``--seeds`` seeds (the lower readings), then on the first
``--controls`` of them the control (the program's own bfloat16 path in
place of the float32 one that the configuration states) and each fault
of :mod:`portbench.faults` (the upper readings).  Prints one JSON line
per reading and a summary; ``--out`` also writes them all as JSON.
The benchmark's own runs never run this.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEED0 = 2**31 + 11


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import checks, faults, harness
    if not torch.cuda.is_available():
        harness.say("control.py reads on the card only")
        return 2
    spec = harness.load(ROOT, args.workload)
    seeds = [SEED0 + 7919 * i for i in range(args.seeds)]
    runs = [("program", s, None, None) for s in seeds]
    for s in seeds[:args.controls]:
        runs.append(("control_bf16", s, torch.bfloat16, None))
        runs += [(f"fault_{k}", s, None, k) for k in faults.KINDS]
    readings = []
    for label, seed, dtype, fault in runs:
        t = time.perf_counter()
        if fault is None:
            res = harness.run_cell(spec, seed, 0.0, False, "cuda", t, dtype)
        else:
            with faults.planted(fault, seed):
                res = harness.run_cell(spec, seed, 0.0, False, "cuda", t)
        row = {"run": label, "seed": seed, "correct": res["correct"],
               **{k: v["value"] for k, v in res["checks"].items()}}
        readings.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for label in dict.fromkeys(r["run"] for r in readings):
        rows = [r for r in readings if r["run"] == label]
        agg = max if label == "program" else min
        summary[label] = {k: agg(r[k] for r in rows) for k in checks.NAMES}
    print(json.dumps({"workload": args.workload,
                      "device": torch.cuda.get_device_name(0),
                      "lower_max_program": summary.pop("program"),
                      "upper_min": summary}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "readings": readings}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
