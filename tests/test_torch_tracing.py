"""The port's spans and counters (utils/tracing.py) on the face-ID main path.

On the CPU, on a small pipeline (the trained 64-px detector of
tests/fixtures/trained_mnet64.npz and seeded SmallCNN heads): off, nothing
is recorded and the results are those of a traced call; under a
torch.profiler session, ``extract_batch`` records each stage once under
``pipeline.extract_batch``, at the Chrome trace's ``user_annotation``
times within 0.5 ms; served through ``serve(..., dynamic_batching=True)``,
the handler's, queue's and batch's spans share request and batch ids; a
TraceSetting session's ``trace.json`` holds the stages; the store keeps
one session at a time and at most ``LIMIT`` spans.

Marked ``gpu``, on the card: the detector's and the heads' CUDA-event times
are above 0 and within their host spans, and ``host_syncs`` over one
``extract_batch`` equals the syncs ``torch.cuda.set_sync_debug_mode``
reports over the same call, and is 5 for a batch whose faces all align.  This file imports no JAX, so on the card it
runs without the conftest:
``python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_tracing.py``.
"""

import contextlib
import json
import os
import warnings

import numpy as np
import pytest
import torch

from rs_face_detection_tpu_torch.configs import FaceDetectionConfig, FacePipelineConfig
from rs_face_detection_tpu_torch.models import registry as preg
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.heads import SmallCNN
from rs_face_detection_tpu_torch.pipeline.face_pipeline import FacePipeline
from rs_face_detection_tpu_torch.utils import tracing
from deadlines import RPC_S, in_threads

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = "face_detection_retina"
DET_KW = dict(image_size=(64, 64), confidence_threshold=0.3, max_candidates=64, max_detections=16)
STAGES = ["pipeline.decode", "pipeline.letterbox", "detect", "pipeline.select", "heads", "pipeline.assemble"]


def make_pipeline(device):
    torch.manual_seed(0)
    family = "retinaface_mobilenet025"
    det = weights.load_model(family, weights.state_dict_from_jax(family, os.path.join(FIXTURES, "trained_mnet64.npz")))
    reg = preg.ModelRegistry(device)
    for name, shape, module in ((DET, (64, 64, 3), det),
                                ("face_quality", (112, 112, 3), SmallCNN(4, (8, 16), True).eval()),
                                ("face_identification", (112, 112, 3), SmallCNN(512, (8, 16), False).eval())):
        reg.register(preg.ModelSpec(name, shape, "test"), module)
    return FacePipeline(FacePipelineConfig(detection=FaceDetectionConfig(**DET_KW)), device=device, registry=reg), reg


@pytest.fixture(scope="module")
def pipe():
    return make_pipeline("cpu")[0]


def encoded_frames():
    """The trained scene and five frames of the AP set, as JPEGs."""
    cv2 = pytest.importorskip("cv2")
    with np.load(os.path.join(FIXTURES, "golden_trained_scene.npz")) as g:
        scene = g["image"]
    with np.load(os.path.join(FIXTURES, "ap_eval_set.npz")) as d:
        ap = list(d["images"][:5])
    return [cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes() for img in (scene, *ap)]


@pytest.fixture(scope="module")
def payloads():
    return encoded_frames()


@contextlib.contextmanager
def profiled(cuda=False):
    """A torch.profiler session of every thread, as TraceSetting opens one:
    the store's session starts with it."""
    activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    prof = torch.profiler.profile(activities=activities,
                                  experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))
    prof.start()
    tracing.begin_session()
    try:
        yield prof
    finally:
        prof.stop()


def same_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.face_count, x.face_quality, x.quality_score) == (y.face_count, y.face_quality, y.quality_score)
        for u, v in ((x.facial_feature, y.facial_feature), (x.selected_face_box, y.selected_face_box)):
            assert (u is None) == (v is None)
            if u is not None:
                np.testing.assert_array_equal(u, v)


def test_off_records_nothing_and_changes_no_result(pipe, payloads):
    assert not tracing.enabled()
    assert tracing.span("pipeline.decode") is tracing.OFF
    before = tracing.read()
    off = pipe.extract_batch(payloads)
    tracing.host_sync(torch.device("cuda"))
    tracing.record("runtime.queue", 0, 1, request=1)
    after = tracing.read()
    assert after.spans == before.spans and after.counters == before.counters and after.anchor == before.anchor
    with profiled():
        on = pipe.extract_batch(payloads)
    same_results(on, off)
    assert any(r.facial_feature is not None for r in off), "the batch must reach the heads"


def test_stage_spans_nest_under_extract_batch(pipe, payloads):
    with profiled():
        results = pipe.extract_batch(payloads)
    snap = tracing.read()
    (top,) = snap.named("pipeline.extract_batch")
    assert top.attrs == {"images": len(payloads), "faces": sum(r.facial_feature is not None for r in results)}
    children = sorted(snap.children(top), key=lambda s: s.start_ns)
    assert [s.name for s in children] == STAGES
    for s in children:
        assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns and s.tid == top.tid
        assert s.device_ms is None  # no CUDA events on the CPU
    covered = sum(s.end_ns - s.start_ns for s in children)
    assert covered >= 0.9 * (top.end_ns - top.start_ns)
    # the pool decoded every payload; no host_syncs: the CPU waits on no stream
    pooled = {"decode_pooled": len(payloads)}
    assert top.counts == pooled and snap.counters == pooled


def test_single_image_path_has_the_same_stages(pipe, payloads):
    with profiled():
        result = pipe.extract(payloads[0])
    snap = tracing.read()
    (top,) = snap.named("pipeline.extract")
    assert top.attrs == {"images": 1, "faces": int(result.facial_feature is not None)}
    assert [s.name for s in sorted(snap.children(top), key=lambda s: s.start_ns)] == STAGES


def test_the_batch_decode_runs_on_the_pool(monkeypatch, pipe, payloads):
    """The ``pipeline.decode`` span holds its pool threads, the batch span the
    images decoded there, and the benchmark's readers read that count; on a
    program that decodes on one thread they read nothing."""
    from benchmark import spans
    from benchmark.manifest import Manifest

    with profiled():
        pipe.extract_batch(payloads[:4])
    snap = tracing.read()
    (decode,) = snap.named("pipeline.decode")
    (top,) = snap.named("pipeline.extract_batch")
    assert 1 <= decode.attrs["workers"] <= 4
    assert top.counts["decode_pooled"] == 4
    assert spans.count_per_batch(snap, "decode_pooled") == 4.0
    man = Manifest(REPO)
    readers = [man.reader(m) for m in man.data["per_layer"]
               if m["name"].startswith("pipeline.decode_pooled_per_batch.")]
    assert len(readers) == 2 and [r.read({}) for r in readers] == [4.0, 4.0]
    top.counts = {}  # a batch of the serial decode
    monkeypatch.setattr(tracing, "read", lambda: tracing.Snapshot([top, decode], {}, snap.anchor))
    assert [r.read({}) for r in readers] == [None, None]


def test_stage_spans_are_on_the_chrome_trace_clock(pipe, payloads, tmp_path):
    with profiled() as prof:
        pipe.extract_batch(payloads)
    snap = tracing.read()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    events = {e["name"]: e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    for s in [snap.named("pipeline.extract_batch")[0]] + [snap.named(n)[0] for n in STAGES]:
        e = events[s.name]
        assert abs(float(e["ts"]) + base_us - snap.trace_us(s.start_ns)) < 500.0, s.name


def test_a_new_session_starts_empty(pipe, payloads):
    with profiled():
        pipe.extract_batch(payloads[:2])
    first = tracing.read()
    # a bare profiler, as the benchmark's traced sub-window opens one: the
    # read above closed the first session, so the first span opens another
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        pipe.extract_batch(payloads[:3])
    finally:
        prof.stop()
    second = tracing.read()
    assert [s.attrs["images"] for s in second.named("pipeline.extract_batch")] == [3]
    assert second.anchor != first.anchor
    assert tracing.read().spans == second.spans  # a read leaves the session's spans


def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 4)
    monkeypatch.setattr(tracing, "_STORE", tracing._Store())
    with profiled():
        for i in range(10):
            with tracing.span("pipeline.decode") as sp:
                sp.set("i", i)
    snap = tracing.read()
    assert [s.attrs["i"] for s in snap.spans] == [6, 7, 8, 9] and snap.dropped == 6


def test_a_span_open_at_the_stop_is_cut(monkeypatch):
    monkeypatch.setattr(tracing, "_STORE", tracing._Store())
    with profiled():
        with tracing.span("pipeline.decode"):
            pass
        top = tracing.span("pipeline.extract_batch")
        top.__enter__()
        with tracing.span("detect"):
            pass
    top.__exit__(None, None, None)  # ends after the profiler stopped
    snap = tracing.read()
    assert [s.name for s in snap.spans] == ["pipeline.decode", "detect"] and snap.cut == 1


def test_counts_roll_up_to_the_enclosing_span(monkeypatch):
    monkeypatch.setattr(tracing, "_STORE", tracing._Store())
    card = torch.device("cuda")  # host_sync counts for a CUDA device; nothing runs on one here
    with profiled():
        with tracing.span("pipeline.extract_batch"):
            tracing.host_sync(card, 2)
            with tracing.span("detect"):
                tracing.host_sync(card, 3)
                tracing.host_sync(torch.device("cpu"), 5)
    snap = tracing.read()
    assert snap.named("detect")[0].counts == {"host_syncs": 3}
    assert snap.named("pipeline.extract_batch")[0].counts == {"host_syncs": 5}
    assert snap.counters == {"host_syncs": 5}


def test_threads_lose_no_span_and_no_count(monkeypatch):
    """More threads than cores with a short switch interval: every span and
    count lands in the store once."""
    import sys

    monkeypatch.setattr(tracing, "_STORE", tracing._Store())
    card, threads, each = torch.device("cuda"), 4 * (os.cpu_count() or 1), 50
    old = sys.getswitchinterval()

    def work():
        for _ in range(each):
            with tracing.span("pipeline.extract_batch"):
                with tracing.span("detect"):
                    tracing.host_sync(card)

    sys.setswitchinterval(1e-6)
    try:
        with profiled():
            in_threads(lambda _: work(), threads, "tracing")
    finally:
        sys.setswitchinterval(old)
    snap = tracing.read()
    tops = snap.named("pipeline.extract_batch")
    assert len(tops) == len(snap.named("detect")) == threads * each
    assert all(s.counts == {"host_syncs": 1} for s in tops)
    assert snap.counters == {"host_syncs": threads * each}
    assert {len(snap.children(s)) for s in tops} == {1}


@pytest.fixture(scope="module")
def served():
    grpc = pytest.importorskip("grpc")  # noqa: F841
    from rs_face_detection_tpu_torch.runtime.server import FacePipelineClient, serve

    pipeline, reg = make_pipeline("cpu")
    server = serve(pipeline, reg, port=0, max_workers=8, dynamic_batching=True, batch_delay_ms=50.0)
    client = FacePipelineClient("localhost", server._rsfd_port, timeout_s=RPC_S)
    yield client
    client.close()
    server.stop(0)


def test_served_spans_share_request_and_batch_ids(served, payloads):
    served.extract(payloads[0])  # builds the batcher outside the session
    with profiled():
        outs = in_threads(lambda i: served.extract(payloads[i]), len(payloads), "extract client", 2 * RPC_S)
    assert all(o is not None and "error" not in o for o in outs)
    snap = tracing.read()
    handlers = snap.named("runtime.extract")
    ids = sorted(s.attrs["request"] for s in handlers)
    assert len(ids) == len(payloads) and len(set(ids)) == len(ids)
    for s in handlers:
        (wait,) = snap.children(s, "runtime.wait")
        assert s.start_ns <= wait.start_ns <= wait.end_ns <= s.end_ns
    queued = {s.attrs["request"]: s for s in snap.named("runtime.queue")}
    assert sorted(queued) == ids
    batches = {s.attrs["batch"]: s for s in snap.named("runtime.batch")}
    assert len(batches) < len(payloads)  # the requests coalesced
    for bid, b in batches.items():
        assert sorted(b.attrs["requests"]) == sorted(r for r, q in queued.items() if q.attrs["batch"] == bid)
        (work,) = snap.children(b, "pipeline.extract_batch")
        assert work.attrs["images"] == len(b.attrs["requests"])
        for r in b.attrs["requests"]:
            assert queued[r].end_ns == b.start_ns  # the queue's end is the batch's start, one clock read
    for q in queued.values():
        assert q.start_ns <= q.end_ns


def test_trace_setting_writes_the_pipeline_spans(served, payloads, tmp_path):
    started = served.trace_setting("start", trace_dir=str(tmp_path / "tr"))
    assert started["active"] is True
    served.extract(payloads[0])
    stopped = served.trace_setting("stop")
    with open(os.path.join(stopped["dir"], "trace.json")) as f:
        trace = json.load(f)
    names = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"runtime.extract", "runtime.wait", "runtime.batch", "pipeline.extract_batch", *STAGES} <= names
    assert len(tracing.read().named("runtime.extract")) == 1


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_device_times_lie_within_their_host_spans(card, payloads):
    pipeline, _ = make_pipeline(card)
    pipeline.extract_batch(payloads)
    torch.cuda.synchronize()
    with profiled(cuda=True):
        pipeline.extract_batch(payloads)
    snap = tracing.read()
    for name in ("detect", "heads"):
        (s,) = snap.named(name)
        assert 0 < s.device_ms <= (s.end_ns - s.start_ns) * 1e-6, name


@pytest.mark.gpu
def test_host_syncs_equal_what_sync_debug_mode_reports(card, payloads):
    pipeline, _ = make_pipeline(card)
    pipeline.extract_batch(payloads)
    torch.cuda.synchronize()
    with profiled(cuda=True):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                results = pipeline.extract_batch(payloads)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    synced = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    (top,) = tracing.read().named("pipeline.extract_batch")
    assert any(r.facial_feature is not None for r in results)
    assert top.counts.get("host_syncs", 0) == synced > 0


@pytest.mark.gpu
def test_a_batch_whose_faces_all_align_makes_five_host_syncs(card, payloads):
    """The scales', the face indices' and the warp matrices' uploads, one
    fetch of the detections and one of the heads' results: every device
    constant was made by the warm-up call."""
    pipeline, _ = make_pipeline(card)
    pipeline.extract_batch(payloads)
    torch.cuda.synchronize()
    with profiled(cuda=True):
        results = pipeline.extract_batch(payloads)
    (top,) = tracing.read().named("pipeline.extract_batch")
    assert top.attrs["faces"] == sum(r.facial_feature is not None for r in results) > 0
    assert top.counts.get("host_syncs", 0) == 5
