"""The port never imports JAX: every module loads in a process without it."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import rs_face_detection_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print(json.dumps({"modules": names, "jax": loaded}))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["jax"] == []
    for name in (
        "kernels.build", "kernels.nms", "kernels.stem", "ops.nms", "ops.image", "ops.stem",
        "models.resnet", "models.retinaface", "models.weights", "pipeline.detection",
        "pipeline.face_pipeline", "serving.detection_server", "utils.image_io",
    ):
        assert f"rs_face_detection_tpu_torch.{name}" in report["modules"]
