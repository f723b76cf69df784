"""The port's JSON-over-gRPC facade (runtime/server.py) against the JAX package's.

A JAX server and a port server (on the CPU) serve the same weights: the
trained 64-px detector of tests/fixtures/trained_mnet64.npz and SmallCNN
quality and embedding heads (as tests/test_torch_registry.py bridges them),
and for EkycVerify the tiny eKYC registry of that file.  The JAX package's
own ``FacePipelineClient`` talks to both.  Gates (PERF.md section 2):

  - Extract: ``face_count`` and ``face_quality`` equal, the selected box
    within 1e-2 px, the embedding cosine >= 0.9999; the port's reply equals
    its own ``FacePipeline.extract`` exactly (JSON carries f32 exactly);
  - Detect and DetectStream: the same face counts, boxes and landmarks
    within 1e-2 px; the port's replies equal its direct calls exactly;
  - with ``dynamic_batching=True``, concurrent Detect and Extract calls
    coalesce (fewer batches than requests) and every reply agrees with the
    direct call (boxes within 1e-3 px, cosine >= 0.9999);
  - EkycVerify: the booleans equal, the similarity within 1e-4, the boxes
    within 1e-2 px; the port's reply equals its ``verify`` exactly;
  - the repository verbs, ModelConfig, ModelStatistics counts after the
    same traffic and ModelMetadata (but for ``platform``) are equal; the
    generic ModelInfer agrees within 1e-5 of max|output|; ServerMetadata
    names the port and its device; TraceSetting runs torch.profiler and
    leaves a Chrome trace.
"""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

grpc = pytest.importorskip("grpc")

from rs_face_detection_tpu.configs import FaceDetectionConfig, FacePipelineConfig
from rs_face_detection_tpu.models import registry as jreg
from rs_face_detection_tpu.models.heads import init_small_cnn as j_init_small_cnn
from rs_face_detection_tpu.models.retinaface import init_retinaface
from rs_face_detection_tpu.models.scrfd import init_scrfd
from rs_face_detection_tpu.pipeline.ekyc_pipeline import EKYCPipeline as JEKYCPipeline
from rs_face_detection_tpu.pipeline.face_pipeline import FacePipeline as JFacePipeline
from rs_face_detection_tpu.runtime.server import FacePipelineClient
from rs_face_detection_tpu.runtime.server import serve as jserve
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig as PDetectionConfig
from rs_face_detection_tpu_torch.configs import FacePipelineConfig as PConfig
from rs_face_detection_tpu_torch.models import registry as preg
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.heads import SmallCNN, small_cnn_map
from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import EKYCPipeline
from rs_face_detection_tpu_torch.pipeline.face_pipeline import FacePipeline
from rs_face_detection_tpu_torch.runtime.server import extract_reply
from rs_face_detection_tpu_torch.runtime.server import serve as pserve
from deadlines import RPC_S, in_threads

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
WIDTHS = (8, 16)
DET = "face_detection_retina"
DET_KW = dict(image_size=(64, 64), confidence_threshold=0.3, max_candidates=64, max_detections=16)
BOX_TOL = 1e-2
COS_MIN = 0.9999


def small_pair(num_outputs, size, seed, softmax=True):
    model, variables = j_init_small_cnn(num_outputs, size, softmax=softmax, widths=WIDTHS, seed=seed)
    variables = jax.tree.map(np.asarray, variables)
    port = SmallCNN(num_outputs, WIDTHS, softmax).eval()
    port.load_state_dict(weights.state_dict_from_jax("small_cnn", variables, mapping=small_cnn_map(WIDTHS)))
    return model, variables, port


def paired_registries(entries):
    """{name: (input HWC, JAX model, variables, port module)} -> (JAX, port)."""
    j, p = jreg.ModelRegistry(), preg.ModelRegistry("cpu")
    for name, (shape, model, variables, port) in entries.items():
        j.register_builder(name, lambda n=name, s=shape, m=model, v=variables: (jreg.ModelSpec(n, s, "test"), m, v))
        p.register_builder(name, lambda n=name, s=shape, m=port: (preg.ModelSpec(n, s, "test"), m))
    return j, p


def face_registries():
    det_model, _ = init_retinaface("mobilenet025", (64, 64), seed=0)
    det_vars = jreg._unflatten(weights.flat_variables(os.path.join(FIXTURES, "trained_mnet64.npz")))
    det_port = weights.load_model("retinaface_mobilenet025", weights.state_dict_from_jax("retinaface_mobilenet025", det_vars))
    return paired_registries({
        DET: ((64, 64, 3), det_model, det_vars, det_port),
        "face_quality": ((112, 112, 3), *small_pair(4, (112, 112), 1)),
        "face_identification": ((112, 112, 3), *small_pair(512, (112, 112), 2, softmax=False)),
    })


def pipelines(j, p):
    return (JFacePipeline(FacePipelineConfig(detection=FaceDetectionConfig(**DET_KW)), registry=j),
            FacePipeline(PConfig(detection=PDetectionConfig(**DET_KW)), device="cpu", registry=p))


def jpeg(img):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    assert ok
    return buf.tobytes()


@pytest.fixture(scope="module")
def payloads():
    with np.load(os.path.join(FIXTURES, "golden_trained_scene.npz")) as g:
        scene = g["image"]
    with np.load(os.path.join(FIXTURES, "ap_eval_set.npz")) as d:
        ap = list(d["images"][:7])
    return [jpeg(img) for img in (scene, *ap)]


@pytest.fixture(scope="module")
def servers():
    j, p = face_registries()
    jpipe, ppipe = pipelines(j, p)
    js, ps = jserve(jpipe, j, port=0), pserve(ppipe, p, port=0)
    jc, pc = (FacePipelineClient("localhost", s._rsfd_port, timeout_s=RPC_S) for s in (js, ps))
    yield {"jax": (js, j, jc, jpipe), "port": (ps, p, pc, ppipe)}
    for c in (jc, pc):
        c.close()
    js.stop(0)
    ps.stop(0)


def cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def assert_extract_close(got, want, cos_min=COS_MIN, box_tol=BOX_TOL):
    assert "error" not in got and "error" not in want, (got, want)
    assert got["face_count"] == want["face_count"]
    assert got["face_quality"] == want["face_quality"]
    assert (got["selected_face_box"] is None) == (want["selected_face_box"] is None)
    if want["selected_face_box"] is not None:
        np.testing.assert_allclose(got["selected_face_box"], want["selected_face_box"], rtol=0, atol=box_tol)
        assert cosine(got["facial_feature"], want["facial_feature"]) >= cos_min


def assert_detect_close(got, want, tol=BOX_TOL):
    assert "error" not in got and "error" not in want, (got, want)
    g, w = np.asarray(got["boxes"]), np.asarray(want["boxes"])
    assert g.shape == w.shape
    if w.size:
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        np.testing.assert_allclose(np.asarray(got["keypoints"]), np.asarray(want["keypoints"]), rtol=0, atol=tol)


def stats(client, name):
    s = client.model_statistics(name)
    return s["inference_count"], s["execution_count"], s["batch_size_counts"]


def test_extract_and_detect_match_jax(servers, payloads):
    (_, _, jc, _), (_, _, pc, ppipe) = servers["jax"], servers["port"]
    names = (DET, "face_quality", "face_identification")
    before = {n: (stats(jc, n), stats(pc, n)) for n in names}
    replies = []
    for payload in payloads:
        got, want = pc.extract(payload), jc.extract(payload)
        assert_extract_close(got, want)
        replies.append(got)
        assert_detect_close(pc.detect(payload), jc.detect(payload))
    assert sum(r["facial_feature"] is not None for r in replies) >= 3
    for n in names:  # the same traffic moved the statistics alike
        (j0, p0), (j1, p1) = before[n], (stats(jc, n), stats(pc, n))
        assert (p1[0] - p0[0], p1[1] - p0[1]) == (j1[0] - j0[0], j1[1] - j0[1]), n
        assert p1[2] == j1[2], n
    for payload, got in zip(payloads, replies):  # the port's replies are its direct calls
        assert got == extract_reply(ppipe.extract(payload))
        det, kps = ppipe.face_detection(cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR))
        assert pc.detect(payload) == {"boxes": det.tolist(), "keypoints": kps.tolist()}
    assert pc.extract(b"definitely not an image").keys() == jc.extract(b"definitely not an image").keys() == {"error"}


def test_detect_stream_matches_jax(servers, payloads):
    (_, _, jc, _), (_, _, pc, ppipe) = servers["jax"], servers["port"]
    # a stream has no deadline of its own
    (got,) = in_threads(lambda _: list(pc.detect_stream(payloads)), 1, "the port's DetectStream")
    (want,) = in_threads(lambda _: list(jc.detect_stream(payloads)), 1, "JAX's DetectStream")
    assert len(got) == len(want) == len(payloads)
    for g, w in zip(got, want):
        assert_detect_close(g, w)
    from rs_face_detection_tpu_torch.serving.detection_server import DetectionServer

    with DetectionServer(ppipe.face_detection, batch_size=4) as server:
        direct = [r for i in range(0, len(payloads), 4) for r in server.detect_batch(payloads[i : i + 4])]
    assert got == [{"boxes": d.tolist(), "keypoints": k.tolist()} for d, k in direct]


def test_model_infer_repository_and_metadata_match(servers):
    (_, _, jc, _), (_, _, pc, _) = servers["jax"], servers["port"]
    batch = np.random.default_rng(3).normal(size=(2, 112, 112, 3)).astype(np.float32)
    want = jc.model_infer("face_quality", batch)
    np.testing.assert_allclose(pc.model_infer("face_quality", batch), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    assert pc.model_infer_multi(DET, batch[:1, :64, :64]).__len__() == 9
    with pytest.raises(RuntimeError):
        pc.model_infer("nonexistent_model", batch)
    for ask in (lambda c: c.repository_index(), lambda c: c.model_config("face_quality"),
                lambda c: c.model_config("nonexistent"), lambda c: c.model_ready(DET)):
        assert ask(pc) == ask(jc)
    for c in (jc, pc):
        assert c.repository_model_unload("face_quality") == {"name": "face_quality", "loaded": False}
    assert pc.repository_index() == jc.repository_index()
    for c in (jc, pc):
        assert c.repository_model_load("face_quality") == {"name": "face_quality", "loaded": True}
    assert pc.repository_model_load("nonexistent").keys() == jc.repository_model_load("nonexistent").keys()
    jm, pm = jc.model_metadata(DET), pc.model_metadata(DET)
    assert (jm.pop("platform"), pm.pop("platform")) == ("jax_xla", "pytorch_libtorch")
    assert pm == jm and pm["inputs"][0]["shape"] == [-1, 64, 64, 3]
    assert pc.model_metadata("nonexistent").keys() == {"error"}
    meta = pc.server_metadata()
    assert (meta["name"], meta["backend"], meta["device_count"]) == ("rs_face_detection_tpu_torch", "cpu", 1)
    assert {k: v for k, v in meta.items() if k not in ("name", "backend", "device_count")} == {
        k: v for k, v in jc.server_metadata().items() if k not in ("name", "backend", "device_count")}


def test_trace_setting_round_trip(servers, tmp_path, payloads):
    _, _, pc, _ = servers["port"]
    assert pc.trace_setting("status") == {"active": False, "dir": None}
    started = pc.trace_setting("start", trace_dir=str(tmp_path / "tr"))
    assert started == {"active": True, "dir": str(tmp_path / "tr")}
    again = pc.trace_setting("start")
    assert "error" in again and again["dir"] == started["dir"]
    pc.detect(payloads[0])
    stopped = pc.trace_setting("stop")
    assert stopped == {"active": False, "dir": started["dir"]}
    with open(os.path.join(stopped["dir"], "trace.json")) as f:
        trace = f.read()
    # the Detect ran on another handler thread than start and stop: its
    # convolutions are in the trace all the same
    assert "traceEvents" in trace and "aten::conv2d" in trace
    assert "error" in pc.trace_setting("stop")
    assert "error" in pc.trace_setting("bogus")


@pytest.mark.parametrize("verb", ["detect", "extract"])
def test_dynamic_batching_coalesces(payloads, verb):
    """8 client threads at once: fewer batches than requests, every reply
    agreeing with the direct call on the same payload."""
    _, p = face_registries()
    ppipe = FacePipeline(PConfig(detection=PDetectionConfig(**DET_KW)), device="cpu", registry=p)
    server = pserve(ppipe, p, port=0, max_workers=8, dynamic_batching=True, batch_delay_ms=50.0)
    client = FacePipelineClient("localhost", server._rsfd_port, timeout_s=RPC_S)
    try:
        call = getattr(client, verb)
        call(payloads[0])
        outs = in_threads(lambda i: call(payloads[i]), len(payloads), f"{verb} client", 2 * RPC_S)
        if verb == "detect":
            for payload, out in zip(payloads, outs):
                det, kps = ppipe.face_detection(cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR))
                assert_detect_close(out, {"boxes": det.tolist(), "keypoints": kps.tolist()}, tol=1e-3)
            key = "dynamic_batching_stats"
        else:
            for out, r in zip(outs, ppipe.extract_batch(payloads)):
                assert_extract_close(out, extract_reply(r), box_tol=1e-3)
            assert "error" in client.extract(b"not an image")  # the batcher isolates the bad item
            key = "extract_dynamic_batching_stats"
        meta = client.server_metadata()
        assert meta["dynamic_batching"] is True
        batched = meta[key]
        assert batched["requests"] >= len(payloads) + 1
        assert batched["batches"] < batched["requests"]
        assert any(int(k) > 1 for k in batched["batch_size_counts"])
    finally:
        client.close()
        server.stop(0)


def ekyc_registries():
    scrfd_model, scrfd_vars = init_scrfd((96, 96), width=8, seed=0)
    scrfd_vars = jax.tree.map(np.asarray, scrfd_vars)
    scrfd_port = weights.load_model("scrfd", weights.state_dict_from_jax("scrfd", scrfd_vars))
    return paired_registries({
        "scrfd": ((96, 96, 3), scrfd_model, scrfd_vars, scrfd_port),
        "face_id": ((112, 112, 3), *small_pair(512, (112, 112), 3, softmax=False)),
        "face_attribute": ((128, 128, 3), *small_pair(2, (128, 128), 4)),
        "face_quality_vp": ((112, 112, 3), *small_pair(2, (112, 112), 5)),
        "face_anti_spoofing_crop_l14": ((224, 224, 3), *small_pair(2, (224, 224), 6)),
        "face_anti_spoofing_fi_l14": ((224, 224, 3), *small_pair(2, (224, 224), 7)),
    })


def test_ekyc_verify_matches_jax():
    j, p = ekyc_registries()
    jekyc = JEKYCPipeline(registry=j, detector_image_size=(96, 96))
    pekyc = EKYCPipeline(device="cpu", detector_image_size=(96, 96), registry=p)
    face = np.load(os.path.join(FIXTURES, "real_face_crop.npz"))["face"]
    card = np.full((100, 150, 3), 200, np.uint8)
    card[20:80, 10:70] = face[(np.arange(60) * 160) // 60][:, (np.arange(60) * 160) // 60]
    selfie = np.ascontiguousarray(face[(np.arange(120) * 160) // 120][:, (np.arange(100) * 160) // 100])
    js, ps = jserve(None, j, port=0, ekyc_pipeline=jekyc), pserve(None, p, port=0, ekyc_pipeline=pekyc)
    jc, pc = (FacePipelineClient("localhost", s._rsfd_port, timeout_s=RPC_S) for s in (js, ps))
    try:
        for c_img, s_img in ((card, selfie), (selfie, card)):
            cb, sb = jpeg(c_img), jpeg(s_img)
            got, want = pc.ekyc_verify(cb, sb), jc.ekyc_verify(cb, sb)
            assert got.keys() == want.keys() and "error" not in got
            for k, v in want.items():
                if k == "similarity":
                    assert abs(got[k] - v) <= 1e-4
                elif k.endswith("_box") and v is not None:
                    np.testing.assert_allclose(got[k], v, rtol=0, atol=BOX_TOL)
                elif k == "selfie_quality" and v is not None:
                    assert abs(got[k] - v) <= 1e-4
                else:
                    assert got[k] == v, k
            r = pekyc.verify(cb, sb)
            assert got["similarity"] == r.similarity and got["same_person"] == r.same_person
            assert got["card_face_box"] == (None if r.card_face_box is None else r.card_face_box.tolist())
        assert "error" in pc._call("EkycVerify", b"not json")
    finally:
        jc.close()
        pc.close()
        js.stop(0)
        ps.stop(0)
