"""The readings that the correctness limits are set from, on the card.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 --seconds 3

For each seed of ``--seeds``, a run of the cell as the command makes it,
with a short window at the cell's own load: the numbers the check compares
(the lower readings).  For each seed of ``--control-seeds``, the control:
the reference computed with TF32 on (the precision below the
configuration's float32 with TF32 off) put in the program's place over a
seeded sample of the pool, and judged against the float32 reference by the
same comparison (the upper readings).  One JSON line per reading, then the
largest program reading and the smallest control reading of each number.
All in one process, so that set-up is paid once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, images, schedule, weights
from .manifest import Manifest
from .reference.pipeline import Reference
from .run import ROOT, execute, forbidden_modules


def control(workload: str, seed: int, device, root: str = ROOT, bench_dir=None) -> dict:
    """The control's numbers for one seed: TF32 reference against float32 reference."""
    man = Manifest(root, bench_dir) if bench_dir else Manifest(root)
    cell = man.cell(workload)
    cfg, lim, mix = man.config(cell), man.limits(cell), man.traffic(cell)
    pool, _ = images.make_pool(mix["images"], seed, device)
    states = weights.make_states(cfg, seed, device, root, pool)
    picks = schedule.sample(len(pool), mix["check_sample"], seed)
    jpegs = [pool[i] for i in picks]
    answers = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        answers[tf32] = Reference(cfg, states, lim["margins"], device).answers(jpegs)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    numbers = check.compare(answers[True], answers[False])
    correct, _ = check.verdict(numbers, lim["limits"])
    return dict(numbers, correct=correct)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    program, ctrl = [], []
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        result, details = execute(args.workload, seed, args.seconds, False, device, t0=t,
                                  log=lambda *a: print(*a, file=sys.stderr, flush=True))
        row = dict(details["numbers"], correct=result["correct"], failed=result["failed"])
        program.append(row)
        print(json.dumps({"reading": "program", "seed": seed, **row, "run_s": time.perf_counter() - t}), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        row = control(args.workload, seed, device)
        ctrl.append(row)
        print(json.dumps({"reading": "control", "seed": seed, **row}), flush=True)
    summary = {"workload": args.workload}
    for name in check.NUMBERS:
        if program:
            summary[f"{name}.program_max"] = max(r[name] for r in program)
        if ctrl:
            summary[f"{name}.control_min"] = min(r[name] for r in ctrl)
    summary["program_correct"] = sum(r["correct"] for r in program)
    summary["control_correct"] = sum(r["correct"] for r in ctrl)
    print(json.dumps(summary), flush=True)
    if forbidden_modules():
        print(f"readings: loaded {forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
