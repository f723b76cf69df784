"""The face-ID path's host/device boundary (utils/device.py).

``fetch`` brings tensors of any dtype back exact, in one copy counted as one
``host_sync``; ``device_constant`` uploads a constant once per (values,
dtype, device) and caches nothing while torch.export traces; ``descale``
by a Python float equals descale by a one-element f32 tensor, bit for bit.
The source scan holds the rule: syncs are counted only in utils/device.py,
``ops/`` knows nothing of tracing, and no function of the main path's
modules builds a device tensor from Python data on every call.  No JAX
here.  A CUDA device is faked as in tests/test_torch_tracing.py: the CPU
counts as a card for ``host_sync``.
"""

import ast
import contextlib
import inspect
import os

import numpy as np
import pytest
import torch

from rs_face_detection_tpu_torch.ops.image import normalize
from rs_face_detection_tpu_torch.pipeline.detection import PaddedDetections, RetinaFaceDetection, descale
from rs_face_detection_tpu_torch.utils import device as udev
from rs_face_detection_tpu_torch.utils import tracing

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rs_face_detection_tpu_torch")
#: The main path's modules, which build no device tensor from Python data per call.
MAIN_PATH = ["ops/image.py", "ops/box_decode.py", "pipeline/detection.py", "pipeline/alignment.py",
             "pipeline/face_pipeline.py"]

_RNG = np.random.default_rng(25)
TENSORS = {
    "f32": torch.from_numpy(_RNG.standard_normal((3, 7, 5)).astype(np.float32)),
    "int64": torch.from_numpy(_RNG.integers(-2**40, 2**40, (6,))),
    "bool": torch.from_numpy(_RNG.random((4, 3)) > 0.5),
    "0-d": torch.tensor(17, dtype=torch.int64),
    "empty": torch.zeros((0, 5), dtype=torch.float32),
    "strided": torch.arange(24, dtype=torch.float32).reshape(4, 6)[:, 1::2],
}


@contextlib.contextmanager
def counted(monkeypatch):
    """A profiler session in which ``host_sync`` takes the CPU for a card;
    yields the span whose counts gather the syncs."""
    real = tracing.host_sync
    monkeypatch.setattr(tracing, "host_sync", lambda device, n=1: real(torch.device("cuda"), n))
    monkeypatch.setattr(tracing, "_STORE", tracing._Store())
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with tracing.span("pipeline.extract_batch") as top:
            yield top
    finally:
        prof.stop()


@pytest.mark.parametrize("names", [["f32"], ["int64"], ["bool"], ["0-d"], ["empty"], ["strided"], list(TENSORS)])
def test_fetch_equals_cpu_numpy(names):
    tensors = [TENSORS[n] for n in names]
    got = udev.fetch(*tensors)
    assert len(got) == len(tensors)
    for name, t, g in zip(names, tensors, got):
        want = t.cpu().numpy()
        assert isinstance(g, np.ndarray) and g.dtype == want.dtype and g.shape == want.shape, name
        np.testing.assert_array_equal(g, want, err_msg=name)
        assert g.flags.writeable and not np.shares_memory(g, want), name


def test_fetch_counts_one_host_sync(monkeypatch):
    with counted(monkeypatch) as top:
        udev.fetch(*TENSORS.values())
    assert top.counts == {"host_syncs": 1}


def test_timed_fetch_spans_the_stage(monkeypatch):
    with counted(monkeypatch) as top:
        (det, kps, count), seconds = udev.timed_fetch(
            "detect", torch.device("cpu"), lambda: PaddedDetections(TENSORS["f32"], TENSORS["bool"], TENSORS["0-d"]))
    (span,) = tracing.read().named("detect")
    assert span.parent == top.id and seconds == pytest.approx((span.end_ns - span.start_ns) * 1e-9)
    assert span.counts == top.counts == {"host_syncs": 1} and int(count) == 17
    np.testing.assert_array_equal(det, TENSORS["f32"].numpy())


def test_device_constant_is_made_once_per_key(monkeypatch):
    cpu = torch.device("cpu")
    values = (0.25, -1.5, 3.0)
    udev._uploaded.cache_clear()
    with counted(monkeypatch) as top:
        first = udev.device_constant(values, torch.float32, cpu)
        made = dict(top.counts)
        again = udev.device_constant(list(values), torch.float32, cpu)
    assert again is first and made == top.counts == {"host_syncs": 1}
    assert first.dtype == torch.float32 and first.tolist() == list(values)
    other_dtype = udev.device_constant(values, torch.float64, cpu)
    other_device = udev.device_constant(values, torch.float32, torch.device("meta"))
    assert other_dtype is not first and other_dtype.dtype == torch.float64
    assert other_device is not first and other_device.device.type == "meta"


def test_export_caches_no_traced_constant():
    """A constant first asked for while torch.export traces is made for the
    trace only: the cache then holds a real tensor, not a fake one."""
    mean, scale = (11.0, 22.0, 33.0), (0.5, 0.25, 0.125)

    class Norm(torch.nn.Module):
        def forward(self, x):
            return normalize(x, mean, scale)

    x = torch.arange(12, dtype=torch.float32).reshape(2, 2, 3)
    program = torch.export.export(Norm(), (x,))
    cached = udev.device_constant(mean, torch.float32, torch.device("cpu"))
    assert type(cached) is torch.Tensor and cached.tolist() == list(mean)
    assert torch.equal(program.module()(x), Norm()(x))


@pytest.mark.parametrize("det_scale", [1.0, 0.5, 640 / 720, 640 / 481, 64 / 37])
def test_descale_by_a_float_equals_descale_by_a_tensor(det_scale):
    padded = PaddedDetections(torch.from_numpy(_RNG.random((1, 8, 5), dtype=np.float32) * 640),
                              torch.from_numpy(_RNG.random((1, 8, 5, 2), dtype=np.float32) * 640),
                              torch.tensor([3]))
    by_float = descale(padded, 1.0 / det_scale)
    by_tensor = descale(padded, torch.tensor([1.0 / det_scale], dtype=torch.float32))
    for a, b in zip(by_float, by_tensor):
        assert a.shape == b.shape and torch.equal(a, b)


def _tree(rel):
    with open(os.path.join(PACKAGE, rel)) as f:
        return ast.parse(f.read(), rel)


def _package_files():
    for root, _, files in os.walk(PACKAGE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), PACKAGE)


def test_host_syncs_are_counted_only_at_the_boundary():
    found = []
    for rel in _package_files():
        for node in ast.walk(_tree(rel)):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "host_sync" and rel != os.path.join("utils", "device.py")):
                found.append(f"{rel}:{node.lineno}")
            if rel.startswith("ops" + os.sep) and isinstance(node, ast.ImportFrom):
                names = [a.name for a in node.names]
                if "tracing" in (node.module or "").split(".") or "tracing" in names:
                    found.append(f"{rel}:{node.lineno} imports tracing")
    assert not found, found


@pytest.mark.parametrize("rel", MAIN_PATH)
def test_no_per_call_device_tensor_from_python_data(rel):
    found = []
    for fn in ast.walk(_tree(rel)):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("tensor", "as_tensor") and getattr(node.func.value, "id", None) == "torch"
                    and any(k.arg == "device" for k in node.keywords)):
                found.append(f"{rel}:{node.lineno}")
    assert not found, found


def test_the_detector_has_no_stem_option():
    assert "stem" not in inspect.signature(RetinaFaceDetection.__init__).parameters
