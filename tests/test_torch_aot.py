"""The port's AOT artifacts (runtime/aot.py) and the kernels as custom ops.

  - the four kernels are ``torch.library`` custom ops (``rsfd::nms_mask``,
    ``rsfd::fused_stem``, ``rsfd::attention``, ``rsfd::int8_matmul``) that
    pass ``torch.library.opcheck`` on the CPU (schema, fake tensors against
    the plain version, AOT dispatch);
  - ``export_detector`` / ``load_detector`` round-trip the mnet against the
    JAX package's ``export_detector(det, stem="xla")`` artifact and its
    ``make_batched_fn()`` on the same weights: counts equal, boxes and
    landmarks within 1e-3 px, scores within 1e-5
    (tests/test_torch_detection.py's bounds), and ``torch.equal`` to the
    port's own ``detect_batch``; likewise SCRFD, and the R50 with the fused
    stem, whose constants fold from the weights inside the graph;
  - one loaded program serves any checkpoint of its architecture, the
    artifact carries no parameter tensors, every exported detect graph
    holds NMS as one ``rsfd::nms_mask`` node (no unrolled loop) and the R50
    its stem as one ``rsfd::fused_stem`` node;
  - ``export_model`` of the ResNet-18 classifier against JAX's
    ``export_model`` within 1e-5, and of a bf16 ViT tower (``rsfd::
    attention`` per block) and the int8 face-ID head (one
    ``rsfd::int8_matmul``) equal to their eager forwards;
  - a foreign or wrong-format blob, a wrong leaf shape, a missing leaf and
    a card this host lacks are refused with the reason.
"""

import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.configs import FaceDetectionConfig as JConfig
from rs_face_detection_tpu.models.classifiers import init_resnet18_classifier
from rs_face_detection_tpu.models.retinaface import init_retinaface
from rs_face_detection_tpu.models.scrfd import init_scrfd
from rs_face_detection_tpu.pipeline.detection import RetinaFaceDetection as JDetection
from rs_face_detection_tpu.pipeline.ekyc_pipeline import SCRFDDetection as JSCRFDDetection
from rs_face_detection_tpu.runtime import aot as jaot
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.quantized import quantize_module
from rs_face_detection_tpu_torch.models.vit import cast_for_serving
from rs_face_detection_tpu_torch.ops import attention, nms, quantize, stem
from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import SCRFDDetection
from rs_face_detection_tpu_torch.runtime.aot import export_detector, export_model, load_detector, load_model
from test_torch_detection import _assert_same

torch.set_num_threads(2)

SIZE = (64, 64)
MNET = "retinaface_mobilenet025"


def _canvases(seed, b=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (b, SIZE[1], SIZE[0], 3), dtype=np.uint8), np.ones(b, np.float32)


def _targets(blob):
    """The call_function targets of the artifact's graph, by name."""
    program = load_detector(blob, device="cpu").program if _format(blob) == "rsfd-aot-v1" else \
        load_model(blob, device="cpu").program
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


def _format(blob):
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        (name,) = [n for n in z.namelist() if n.endswith("rsfd_meta.json")]
        return json.loads(z.read(name))["format"]


def _same_padded(got, want_det, want_kps, want_count):
    det, kps, count = (t.numpy() for t in got)
    np.testing.assert_array_equal(count, np.asarray(want_count))
    for i, n in enumerate(count):
        _assert_same(det[i, :n], kps[i, :n], np.asarray(want_det[i, :n]), np.asarray(want_kps[i, :n]))


@pytest.fixture(scope="module")
def mnet():
    """JAX's detector of tests/test_aot.py (seed 3, natural stem) and the
    port's on the same weights."""
    model, variables = init_retinaface("mobilenet025", SIZE, seed=3, stem_s2d=False)
    jdet = JDetection(JConfig(backbone="mobilenet025", image_size=SIZE, confidence_threshold=0.02),
                      model=model, variables=variables)
    sd = weights.state_dict_from_jax(MNET, variables)
    det = RetinaFaceDetection(FaceDetectionConfig(image_size=SIZE, confidence_threshold=0.02),
                              weights.load_model(MNET, sd), device="cpu")
    return jdet, det, export_detector(det, batch_size=2)


# -- the kernels as custom ops ------------------------------------------------


def _op_cases():
    rng = np.random.default_rng(0)
    boxes = torch.from_numpy(np.sort(rng.uniform(0, 50, (2, 16, 4)).astype(np.float32), axis=-1))
    valid = torch.from_numpy(rng.uniform(size=(2, 16)) > 0.2)
    canvas = torch.from_numpy(rng.integers(0, 256, (2, 8, 12, 3), dtype=np.uint8))
    consts = stem.fold_stem_params(
        *(torch.from_numpy(a.astype(np.float32)) for a in (
            rng.normal(size=(4, 4, 12, 64)) / 14.0, rng.uniform(0.5, 1.5, 64), rng.normal(0, 0.1, 64),
            rng.normal(0, 0.1, 64), rng.uniform(0.5, 1.5, 64))),
        (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), 255.0)
    qkv = torch.from_numpy(rng.normal(size=(2, 5, 3, 2, 32)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (40, 7), dtype=np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.1, 7).astype(np.float32))
    return {
        "nms_mask": (nms.nms_mask_op, (boxes, valid, 0.45)),
        "fused_stem": (stem.fused_stem_op, (canvas, *consts)),
        "attention": (attention.attention_op, (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])),
        "int8_matmul_f32": (quantize.int8_matmul_op, (x, q, s, "f32")),
        "int8_matmul_bf16": (quantize.int8_matmul_op, (x, q, s, "bf16")),
    }


@pytest.mark.parametrize("case", ["nms_mask", "fused_stem", "attention", "int8_matmul_f32", "int8_matmul_bf16"])
def test_custom_op_opcheck(case):
    op, args = _op_cases()[case]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


# -- detectors ------------------------------------------------------------------


def test_roundtrip_parity_against_jax(mnet):
    jdet, det, blob = mnet
    loaded = load_detector(blob, device="cpu")
    assert loaded.meta["format"] == "rsfd-aot-v1"
    assert (loaded.meta["layout"], loaded.meta["stem"], loaded.meta["batch_size"]) == ("none", "module", 2)
    assert loaded.meta["image_size"] == list(SIZE) and loaded.meta["detector"] == "RetinaFaceDetection"
    imgs, scales = _canvases(2)
    got = loaded(det.model.state_dict(), imgs, scales)
    direct = det.detect_batch(imgs, scales)
    for g, w in zip(got, (direct.det, direct.kps, direct.count)):
        assert torch.equal(g, w)
    jblob = jaot.export_detector(jdet, batch_size=2, stem="xla")
    jloaded = jaot.load_detector(jblob)
    assert jloaded.meta["layout"] == "none"
    _same_padded(got, *jloaded(jdet.variables, jnp.asarray(imgs), jnp.asarray(scales)))
    ref = jdet.make_batched_fn()(jdet.variables, jnp.asarray(imgs), jnp.asarray(scales))
    _same_padded(got, ref.det, ref.kps, ref.count)
    assert int(np.asarray(ref.count).sum()) > 0


def test_artifact_is_weights_agnostic(mnet):
    """One loaded program serves another checkpoint of the architecture,
    against JAX's program on the same second weights."""
    jdet, det, blob = mnet
    loaded = load_detector(blob, device="cpu")
    model2, variables2 = init_retinaface("mobilenet025", SIZE, seed=7, stem_s2d=False)
    sd2 = weights.state_dict_from_jax(MNET, variables2)
    imgs, scales = _canvases(3)
    d1, _, c1 = loaded(det.model.state_dict(), imgs, scales)
    got = loaded(sd2, imgs, scales)
    assert not torch.equal(d1, got[0]) or not torch.equal(c1, got[2])
    jdet2 = JDetection(JConfig(backbone="mobilenet025", image_size=SIZE, confidence_threshold=0.02),
                       model=model2, variables=variables2)
    ref = jdet2.make_batched_fn()(variables2, jnp.asarray(imgs), jnp.asarray(scales))
    _same_padded(got, ref.det, ref.kps, ref.count)


def test_graph_holds_the_kernels_and_no_parameters(mnet):
    _, det, blob = mnet
    targets = _targets(blob)
    assert targets.count("rsfd.nms_mask.default") == 1
    assert "aten.triu.default" not in targets  # the plain NMS's suppression matrix: no unrolled loop
    program = load_detector(blob, device="cpu").program
    sig = program.graph_signature
    assert not sig.parameters and not sig.buffers
    weight_bytes = sum(t.numel() * t.element_size() for t in det.model.state_dict().values())
    const_bytes = sum(t.numel() * t.element_size() for t in program.constants.values())
    assert const_bytes < 0.01 * weight_bytes, (const_bytes, weight_bytes)  # the anchor table and scalars
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        stored = sum(i.file_size for i in z.infolist() if "/data/" in i.filename)
    assert stored < 0.01 * weight_bytes, stored


def test_prepared_state_is_cached_once_per_state_dict(mnet):
    _, det, blob = mnet
    loaded = load_detector(blob, device="cpu")
    imgs, scales = _canvases(4)
    sd = det.model.state_dict()
    loaded(sd, imgs, scales)
    first = loaded._prepared_cache[0][1]
    loaded(sd, imgs, scales)
    assert len(loaded._prepared_cache) == 1 and loaded._prepared_cache[0][1] is first
    loaded(dict(sd), imgs, scales)  # another dict object: prepared anew, the old entry dropped
    assert len(loaded._prepared_cache) == 1 and loaded._prepared_cache[0][1] is not first


def test_bad_blob_and_bad_state_rejected(mnet):
    _, det, blob = mnet
    buf = io.BytesIO()
    np.savez(buf, meta=np.frombuffer(b'{"format": "other"}', dtype=np.uint8))
    model, variables = init_resnet18_classifier(2, (32, 32), seed=0)
    foreign = [buf.getvalue(), b"not a zip at all",
               jaot.export_model(model, variables, (1, 32, 32, 3), name="q", train=False)]
    for bad in foreign:
        with pytest.raises(ValueError, match="not an rsfd"):
            load_detector(bad, device="cpu")
    with pytest.raises(ValueError, match="rsfd-aot-model-v1"):
        load_model(blob, device="cpu")
    loaded = load_detector(blob, device="cpu")
    imgs, scales = _canvases(5)
    sd = dict(det.model.state_dict())
    key = next(k for k, v in sd.items() if v.dim() == 4)
    with pytest.raises(ValueError, match=f"leaf '{key}' has shape"):
        loaded(dict(sd, **{key: sd[key][:1]}), imgs, scales)
    del sd[key]
    with pytest.raises(ValueError, match="missing"):
        loaded(sd, imgs, scales)


def test_loading_takes_the_card_unless_asked(mnet):
    """An artifact exported on the CPU loads onto the card by default
    (move_to_device_pass): here, without one, it refuses."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_detector(mnet[2])


def test_scrfd_export_roundtrip():
    model, variables = init_scrfd(SIZE, width=8, seed=0)
    jdet = JSCRFDDetection(model=model, variables=variables, image_size=SIZE, confidence_threshold=0.4, registry=None)
    det = SCRFDDetection(model=weights.load_model("scrfd", weights.state_dict_from_jax("scrfd", variables)),
                         device="cpu", image_size=SIZE, confidence_threshold=0.4)
    blob = export_detector(det, batch_size=2)
    loaded = load_detector(blob, device="cpu")
    assert (loaded.meta["detector"], loaded.meta["layout"], loaded.meta["stem"]) == ("SCRFDDetection", "none", "module")
    assert _targets(blob).count("rsfd.nms_mask.default") == 1
    imgs, scales = _canvases(5)
    got = loaded(det.model.state_dict(), imgs, scales)
    direct = det.detect_batch(imgs, scales)
    for g, w in zip(got, (direct.det, direct.kps, direct.count)):
        assert torch.equal(g, w)
    jloaded = jaot.load_detector(jaot.export_detector(jdet, batch_size=2, stem="xla"))
    _same_padded(got, *jloaded(variables, jnp.asarray(imgs), jnp.asarray(scales)))
    assert int(got[2].sum()) > 0


def test_r50_fused_stem_export():
    """The R50's fused stem is one node whose constants fold from the state
    the program is called with."""
    cfg = FaceDetectionConfig(backbone="resnet50", image_size=SIZE, confidence_threshold=0.02, max_candidates=64,
                              max_detections=32)
    family = "retinaface_resnet50"
    det = RetinaFaceDetection(cfg, weights.load_model(family, weights.init_state(family, 0)), device="cpu")
    blob = export_detector(det, batch_size=2)
    targets = _targets(blob)
    assert targets.count("rsfd.fused_stem.default") == 1 and targets.count("rsfd.nms_mask.default") == 1
    loaded = load_detector(blob, device="cpu")
    assert loaded.meta["stem"] == "fused" and loaded.meta["backbone"] == "resnet50"
    imgs, scales = _canvases(6)
    for seed in (0, 1):
        sd = weights.init_state(family, seed)
        direct = RetinaFaceDetection(cfg, weights.load_model(family, sd), device="cpu").detect_batch(imgs, scales)
        got = loaded(sd, imgs, scales)
        for g, w in zip(got, (direct.det, direct.kps, direct.count)):
            assert torch.equal(g, w), seed


# -- models ------------------------------------------------------------------


def test_generic_model_export_roundtrip():
    """export_model of the ResNet-18 classifier against JAX's export_model."""
    model, variables = init_resnet18_classifier(2, (32, 32), seed=0)
    variables = jax.tree.map(np.asarray, variables)
    port = weights.load_model("resnet18_classifier", weights.state_dict_from_jax("resnet18_classifier", variables))
    blob = export_model(port, (2, 3, 32, 32), name="face_quality")
    loaded = load_model(blob, device="cpu")
    assert (loaded.meta["name"], loaded.meta["batch_shape"], loaded.meta["dtype"]) == ("face_quality", [2, 3, 32, 32],
                                                                                      "float32")
    x = np.random.default_rng(5).normal(size=(2, 3, 32, 32)).astype(np.float32)
    got = loaded(port.state_dict(), x)
    with torch.inference_mode():
        assert torch.equal(got, port.eval()(torch.from_numpy(x)))
    jloaded = jaot.load_model(jaot.export_model(model, variables, (2, 32, 32, 3), name="face_quality", train=False))
    want = np.asarray(jloaded(variables, jnp.asarray(x.transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_tower_and_int8_head_export():
    """A bf16 ViT tower holds one rsfd::attention node per block, the int8
    face-ID head one rsfd::int8_matmul; each loaded program equals the eager
    forward."""
    tower = cast_for_serving(weights.load_model("clip_tiny_test", weights.init_state("clip_tiny_test", 0, 2))).eval()
    head = quantize_module(weights.load_model("iresnet18", weights.init_state("iresnet18", 0))).eval()
    rng = np.random.default_rng(7)
    for module, shape, dtype, op, nodes in (
        (tower, (2, 3, 224, 224), torch.bfloat16, "rsfd.attention.default", 2),
        (head, (2, 3, 112, 112), torch.float32, "rsfd.int8_matmul.default", 1),
    ):
        blob = export_model(module, shape, dtype=dtype)
        assert _targets(blob).count(op) == nodes
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
        got = load_model(blob, device="cpu")(module.state_dict(), x)
        with torch.inference_mode():
            assert torch.equal(got, module(x))
