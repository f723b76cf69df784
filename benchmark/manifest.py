"""Finding a cell's pieces by name: BENCHMARK.json, then one file per piece.

- a configuration: ``benchmark/configs/<config>.json``, with the limits of
  its correctness check in ``benchmark/limits/<config>.json``;
- a traffic mix: ``benchmark/traffic/<mix>.json``, whose ``kind`` names a
  driver, ``benchmark/drivers/<kind>.py``; a cell may add or replace
  parameters of its mix in ``benchmark/cells/<cell>.json`` (a served cell's
  rate);
- a per-layer metric: ``benchmark/metrics/<metric>.py``, a module with
  ``UNIT`` and ``read(ctx)``.

A later change adds a cell, a mix, a configuration or a metric by adding
files and entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    def __init__(self, root: str, bench_dir: str = HERE) -> None:
        self.root, self.dir = root, bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def _json(self, *parts: str) -> dict:
        with open(os.path.join(self.dir, *parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        return self._json("configs", f"{cell['config']}.json")

    def limits(self, cell: dict) -> dict:
        return self._json("limits", f"{cell['config']}.json")

    def traffic(self, cell: dict) -> dict:
        mix = self._json("traffic", f"{cell['traffic']}.json")
        override = os.path.join(self.dir, "cells", f"{cell['name']}.json")
        if os.path.exists(override):
            mix.update(self._json("cells", f"{cell['name']}.json"))
        return mix

    def driver(self, kind: str):
        return load_module(os.path.join(self.dir, "drivers", f"{kind}.py"), f"benchmark_driver_{kind}")

    def end_to_end(self, cell: dict) -> List[dict]:
        return [m for m in self.data["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> List[dict]:
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]] if m["moves"] in moved else [])]

    def reader(self, metric: dict):
        return load_module(os.path.join(self.dir, "metrics", f"{metric['name']}.py"),
                           "benchmark_metric_" + metric["name"].replace(".", "_"))

    def read_per_layer(self, cell: dict, ctx: dict) -> Dict[str, dict]:
        out = {}
        for m in self.per_layer(cell):
            value = self.reader(m).read(ctx)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out
