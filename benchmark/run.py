"""The benchmark's one command: one run of one cell on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It refuses (exit 2, no result) without a card,
and never falls back to the CPU.  A run: TF32 off, caches inside the
checkout; weights made on the card from the seed (or read from the
configuration's file); the traffic's JPEG pool from the seed; the port's
FacePipeline on those weights; warm-up of the cell's own shapes; the
traffic driver's measured window; the program freed; the reference over a seeded
sample of the window's requests; the comparison.  With ``--trace 1`` the
window's last seconds run under torch.profiler and the per-layer metrics
are read.  The last line of standard output is the result's JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error and the last key of the result.  A JSON file of the run goes
to ``bench_runs/`` in the checkout.

``--rate`` replaces a served mix's rate, for a knee sweep; a benchmark run
gives none.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "bench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ.setdefault("USE_FLAX", "0")

#: Top-level modules a run may never hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rs_face_detection_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rate", type=float, default=None)
    return p.parse_args(argv)


def execute(workload: str, seed: int, seconds: float, trace: bool, device, root: str = ROOT,
            overrides=None, bench_dir=None, t0: float = T0, log=print):
    """One run on ``device``: (result dict, details dict).  The command runs it
    on the card; tests run it on the CPU at small sizes."""
    import torch

    from . import check, images, port, schedule, weights
    from .counts import model as model_counts
    from .manifest import HERE, Manifest
    from .reference.pipeline import Reference

    man = Manifest(root, bench_dir or HERE)
    cell = man.cell(workload)
    cfg, lim = man.config(cell), man.limits(cell)
    mix = man.traffic(cell)
    mix.update(overrides or {})
    driver = man.driver(mix["kind"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])

    marks = [("imports", time.perf_counter())]
    pool, items = images.make_pool(mix["images"], seed, device)
    marks.append(("pool", time.perf_counter()))
    states = weights.make_states(cfg, seed, device, root, pool)
    marks.append(("weights", time.perf_counter()))
    pipe, registry = port.build(cfg, states, device)
    marks.append(("program", time.perf_counter()))
    log("set-up so far: " + ", ".join(f"{k} {b - a:.3f} s" for (_, a), (k, b) in zip([("start", t0)] + marks, marks)))
    work_dir = os.path.join(root, "bench_runs")
    os.makedirs(work_dir, exist_ok=True)
    env = {"pipe": pipe, "registry": registry, "pool": pool, "items": items, "mix": mix, "cfg": cfg,
           "seconds": seconds, "seed": seed, "trace": trace, "device": device, "root": root,
           "work_dir": work_dir, "t0": t0, "log": log}
    found = forbidden_modules()
    if found:
        raise ImportError(f"set-up loaded {found}")
    out = driver.run(env)
    memory_peak = out["memory_peak_bytes"]
    del pipe, registry, env
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the check: the reference over a seeded sample, after the program is freed
    answers = out["answers"]
    picked = schedule.sample(len(answers), mix["check_sample"], seed)
    reqs = [answers[i] for i in picked]
    distinct = sorted({r["image"] for r in reqs})
    t_ref = time.perf_counter()
    ref = Reference(cfg, states, lim["margins"], device)
    by_image = dict(zip(distinct, ref.answers([pool[i] for i in distinct])))
    convert = out.get("to_answer") or (lambda a: a)
    program = [None if r["answer"] is None else convert(r["answer"]) for r in reqs]
    numbers = check.compare(program, [by_image[r["image"]] for r in reqs])
    correct, lines = check.verdict(numbers, lim["limits"])
    ref_s = time.perf_counter() - t_ref

    if trace:
        metrics = man.read_per_layer(cell, dict(out["ctx"], flops=model_counts.program_flops(cfg)))
    else:
        units = {m["name"]: m["unit"] for m in man.end_to_end(cell)}
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in out["end_to_end"].items() if k in units}
    result = {"correct": bool(correct) and out["failed"] == 0, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics}
    details = {"workload": workload, "seed": seed, "seconds": seconds, "trace": trace,
               "numbers": numbers, "checked": len(reqs), "distinct_images": len(distinct),
               "reference_s": ref_s, "memory_peak_bytes": memory_peak, **out.get("details", {})}
    if trace:
        tr = out["ctx"]["trace"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        details["trace"] = {k: tr[k] for k in ("busy_s", "window_s", "device_ops", "idle_gaps")}
    details["lines"] = lines
    return result, details


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from .manifest import Manifest

    try:
        man = Manifest(ROOT)
        cell = man.cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    overrides = {}
    if args.rate is not None:
        overrides["rate_per_s"] = args.rate
    result, details = execute(args.workload, args.seed, args.seconds, bool(args.trace), device,
                              overrides=overrides, log=lambda *a: print(*a, file=sys.stderr, flush=True))
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
                        "memory_peak_bytes": int(details["memory_peak_bytes"])}
    if args.trace:
        result["device"]["busy_s"] = details["trace"]["busy_s"]
        result["device"]["window_s"] = details["trace"]["window_s"]
    result["checks"] = details["lines"]
    name = f"{args.workload}-{args.seed}-trace{args.trace}.json"
    details["card"] = smi
    with open(os.path.join(ROOT, "bench_runs", name), "w") as f:
        json.dump({"result": result, "details": details}, f, default=float)
    for key, line in details["lines"].items():
        print(f"check {key}: {line['value']!r} (limit {line['limit']!r})", file=sys.stderr)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
