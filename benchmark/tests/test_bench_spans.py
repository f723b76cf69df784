"""The per-layer metrics that read the program's own spans and counters
(benchmark/spans.py and its readers): each gives its value from a synthetic
store, and None from an empty store or from a program without the tracing
module."""

import sys
from types import SimpleNamespace

import pytest

from benchmark.manifest import Manifest
from conftest import REPO

EXPECTED = {
    "pipeline.decode_ms_per_img": 2.0,
    "pipeline.letterbox_ms_per_img": 0.5,
    "pipeline.select_ms_per_img": 0.25,
    "detect.device_ms_per_img": 0.75,
    "heads.device_ms_per_face": 0.5,
    "pipeline.host_syncs_per_batch": 17.0,
}
READERS = [(f"{k}.{kind}", v) for k, v in EXPECTED.items() for kind in ("served", "bulk")]
READERS.append(("runtime.handler_ms.served", 1.5))


def span(i, name, start_ms, end_ms, parent=None, device_ms=None, **attrs):
    return SimpleNamespace(id=i, name=name, parent=parent, start_ns=int(start_ms * 1e6), end_ns=int(end_ms * 1e6),
                           attrs=attrs, counts={}, device_ms=device_ms)


def synthetic():
    from rs_face_detection_tpu_torch.utils import tracing

    batch = span(1, "pipeline.extract_batch", 0, 20, images=4, faces=3)
    batch.counts = {"host_syncs": 17}
    spans = [
        batch,
        span(2, "pipeline.decode", 0, 8, 1),
        span(3, "pipeline.letterbox", 8, 10, 1),
        span(4, "detect", 10, 14, 1, device_ms=3.0),
        span(5, "pipeline.select", 14, 15, 1),
        span(6, "heads", 15, 18, 1, device_ms=1.5),
        span(7, "pipeline.assemble", 18, 18.1, 1),
        span(8, "pipeline.decode", -100, 0),  # of a batch begun before the session: not counted
        span(10, "runtime.extract", 0, 5, request=1),
        span(11, "runtime.wait", 0.5, 4.5, 10),
        span(12, "runtime.extract", 1, 4, request=2),
        span(13, "runtime.wait", 1.5, 2.5, 12),
    ]
    return tracing.Snapshot(spans, {"host_syncs": 17}, (0, 0), 0)


def reader(name):
    man = Manifest(REPO)
    (metric,) = [m for m in man.data["per_layer"] if m["name"] == name]
    return man.reader(metric)


@pytest.mark.parametrize("name,value", READERS)
def test_a_reader_reads_the_synthetic_store(monkeypatch, name, value):
    from rs_face_detection_tpu_torch.utils import tracing

    snap = synthetic()
    monkeypatch.setattr(tracing, "read", lambda: snap)
    assert reader(name).read({}) == pytest.approx(value)


@pytest.mark.parametrize("name", [n for n, _ in READERS])
def test_a_reader_reads_none_from_an_empty_store(monkeypatch, name):
    from rs_face_detection_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "read", lambda: tracing.Snapshot([], {}, (0, 0), 0))
    assert reader(name).read({}) is None


@pytest.mark.parametrize("name", [n for n, _ in READERS])
def test_a_reader_reads_none_without_the_tracing_module(monkeypatch, name):
    import rs_face_detection_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "rs_face_detection_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(utils, "tracing", raising=False)
    with pytest.raises(ImportError):
        from rs_face_detection_tpu_torch.utils import tracing  # noqa: F401
    assert reader(name).read({}) is None
