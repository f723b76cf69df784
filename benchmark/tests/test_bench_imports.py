"""No run holds JAX or the JAX package, by top-level names compared whole."""

import json
import os
import subprocess
import sys

from benchmark import run
from conftest import REPO


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("rs_face_detection_tpu_torch", "rs_face_detection_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not [m for m in run.forbidden_modules() if m in ("rs_face_detection_tpu_torch", "jaxtyping", "flaxen")]
    for name in ("rs_face_detection_tpu", "rs_face_detection_tpu.ops", "jaxlib.xla", "optax", "orbax.checkpoint"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in run.forbidden_modules()


_PROBE = """
import importlib, json, pkgutil, sys
import benchmark
names = [m.name for m in pkgutil.walk_packages(benchmark.__path__, "benchmark.") if not m.name.startswith("benchmark.tests")]
for n in names:
    importlib.import_module(n)
from benchmark.manifest import Manifest
man = Manifest(".")
for m in man.data["per_layer"]:
    man.reader(m)
for w in man.data["workloads"]:
    man.driver(man.traffic(w)["kind"])
import benchmark.run as r
print(json.dumps({"modules": names, "forbidden": r.forbidden_modules()}))
"""


def test_the_harness_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["forbidden"] == []
    assert "benchmark.reference.pipeline" in report["modules"]
