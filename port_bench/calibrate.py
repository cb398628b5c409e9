"""Readings that the check's limits are set from, in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 --seconds 5 [--control <name>]

For each seed, a run of the program; for each control seed, a run with
``pbench.control``'s ``<name>`` in the program's place (default
``bf16_control``, the reference in bfloat16; a planted fault, such as
``mode_b_forced``, gives the upper reading of a number that the control
does not move).  Prints one JSON line a run, then per number compared the
lower reading (the largest of the program's) and the upper (the smallest
of the control's).  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HARNESS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HARNESS)
sys.path[:0] = [HARNESS, ROOT]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", default="bf16_control")
    args = p.parse_args()
    import torch

    from pbench import cells, control, runner
    if not torch.cuda.is_available():
        print("ERROR: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    cell = cells.find(ROOT, HARNESS, args.workload)
    readings = {}
    runs = ([("program", int(s), None) for s in args.seeds.split(",")]
            + [("control", int(s), getattr(control, args.control))
               for s in args.control_seeds.split(",")])
    for kind, seed, hook in runs:
        t0 = time.perf_counter()
        res = runner.run_cell(cell, HARNESS, seed, args.seconds, 0, device,
                              t0, log=lambda s: print(s, file=sys.stderr),
                              setup_hook=hook)
        vals = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"kind": kind, "seed": seed, "checks": vals,
                          "correct": res["correct"],
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        for k, v in vals.items():
            readings.setdefault((kind, k), []).append(v)
    for k in sorted({k for _kind, k in readings}):
        prog = [v for v in readings.get(("program", k), []) if v is not None]
        ctrl = readings.get(("control", k), [])
        print(json.dumps({"number": k,
                          "lower": max(prog) if prog else None,
                          "upper": (None if not ctrl or None in ctrl
                                    else min(ctrl)),
                          "program": prog, "control": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
