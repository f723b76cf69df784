"""A configuration, a traffic mix and a per-layer metric added as files, with
no file of the harness edited."""

import json
import os
import time

import torch

from benchmark.run import execute


def test_new_files_make_a_new_cell(tiny_root):
    bench = os.path.join(tiny_root, "benchmark")
    before = {p: open(os.path.join(bench, p)).read() for p in ("run.py", "manifest.py", "drivers/inproc_closed_loop.py")}
    cfg = json.load(open(os.path.join(bench, "configs", "faceid_mnet.json")))
    cfg["name"] = "faceid_mnet_q"
    cfg["quality"]["threshold"] = 0.6
    json.dump(cfg, open(os.path.join(bench, "configs", "faceid_mnet_q.json"), "w"))
    json.dump(json.load(open(os.path.join(bench, "limits", "faceid_mnet.json"))),
              open(os.path.join(bench, "limits", "faceid_mnet_q.json"), "w"))
    mix = json.load(open(os.path.join(bench, "traffic", "bulk_b32.json")))
    mix["batch"] = 2
    json.dump(mix, open(os.path.join(bench, "traffic", "bulk_b2.json"), "w"))
    with open(os.path.join(bench, "metrics", "images.per_window.bulk.py"), "w") as f:
        f.write('UNIT = "img"\n\n\ndef read(ctx):\n    return float(ctx["images"])\n')
    manifest = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    manifest["configs"].append({"name": "faceid_mnet_q", "source": "x", "file": "benchmark/configs/faceid_mnet_q.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "faceid_mnet_q.bulk_b2", "config": "faceid_mnet_q", "traffic": "bulk_b2",
                                  "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"]:
        if "extract_img_per_s" == m["name"]:
            m["workloads"].append("faceid_mnet_q.bulk_b2")
    manifest["per_layer"].append({"name": "images.per_window.bulk", "unit": "img", "better": "higher",
                                  "source": "host_clock", "layer": "pipeline", "moves": "extract_img_per_s",
                                  "workloads": ["faceid_mnet_q.bulk_b2"]})
    json.dump(manifest, open(os.path.join(tiny_root, "BENCHMARK.json"), "w"))
    result, details = execute("faceid_mnet_q.bulk_b2", 3, 2.0, True, torch.device("cpu"), root=tiny_root,
                              bench_dir=bench, t0=time.perf_counter(), log=lambda *a: None)
    assert result["correct"]
    # a traced run reads counters over the part of the window before the profiler
    assert 0 < result["metrics"]["images.per_window.bulk"]["value"] <= result["attempted"]
    assert details["batches"] * 2 == result["attempted"]
    assert before == {p: open(os.path.join(bench, p)).read() for p in before}
