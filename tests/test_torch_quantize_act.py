"""The calibrated int8-activation RetinaFace: the port's ops/int8_conv.py,
models/quantized.py::Int8ActConv2d and ops/quantize.py::quantize_retinaface
against the JAX package's Int8Conv, ConvBN(quant=True) and
quantize_retinaface, at 64x64.

Tolerances, each from the arithmetic or from a measurement:

  - one conv on identical inputs is exact: the activation codes, the int32
    accumulators (the port's ``torch._int_mm`` against JAX's int8 conv) and
    the f32 output equal bit for bit;
  - the int8 tree: ``weight_q`` and ``weight_scale`` equal JAX's
    ``kernel_q`` and ``kernel_scale``; the port's own calibration gives
    every ``amax`` within rtol 1e-5 of JAX's (measured: 2.4e-6 on the
    MobileNet-0.25, 1.2e-6 on the ResNet-50): the float convs sum in other
    orders;
  - the whole network on JAX's calibrated tree: a layer's f32 epilogue
    (BatchNorm, activation) can differ from XLA's in its last bit, and a
    value that sits at a rounding boundary then gets the neighbouring code;
    the flip carries downstream.  Measured here, codes compared at the input
    of every int8 conv: MobileNet-0.25 73 of 157,568 codes flipped (0.046%),
    none by more than 1, scores within 2.1e-5 and boxes and landmarks within
    8.2e-5 of JAX's; ResNet-50 (seeded, BatchNorm at identity, raw pixels)
    76,060 of 2,014,720 (3.8%) from the first flip at s1b0's 3x3/s2 conv on,
    none by more than 4, scores within 0.31.  The bounds below sit above
    those readings: they are regression bounds for these inputs, not
    accuracy claims.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from rs_face_detection_tpu.models.layers import ConvBN, Int8Conv
from rs_face_detection_tpu.models.retinaface import init_retinaface
from rs_face_detection_tpu.ops import quantize as jquant
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.layers import conv_bn
from rs_face_detection_tpu_torch.models.quantized import Int8ActConv2d, quantize_activations
from rs_face_detection_tpu_torch.ops import int8_conv
from rs_face_detection_tpu_torch.ops.quantize import calibrate, default_calibration_batches, quantize_retinaface

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SIZE = (64, 64)
FAMILIES = {"mobilenet025": "retinaface_mobilenet025", "resnet50": "retinaface_resnet50"}
N_INT8 = {"mobilenet025": 34, "resnet50": 73}


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _act_conv(q_hwio, s, stride=(1, 1), padding=((1, 1), (1, 1)), amax=0.0):
    """An Int8ActConv2d holding JAX-layout int8 weights."""
    kh, kw, i, o = q_hwio.shape
    conv = Int8ActConv2d(nn.Conv2d(i, o, (kh, kw), stride, 0, bias=False))
    conv.padding = padding
    conv.weight_q.copy_(torch.from_numpy(np.ascontiguousarray(q_hwio.transpose(3, 2, 0, 1))))
    conv.weight_scale.copy_(torch.from_numpy(s))
    conv.amax.fill_(amax)
    return conv


def _quantized(backbone):
    """JAX's float RetinaFace and its quantize_retinaface (default
    calibration); the port's bridge of the float model, its own
    quantize_retinaface of it, and the bridge of JAX's int8 tree."""
    family = FAMILIES[backbone]
    model, variables = init_retinaface(backbone, SIZE, seed=0)
    qmodel, qvars = jquant.quantize_retinaface(model, variables, SIZE)
    port_float = weights.load_model(family, weights.state_dict_from_jax(family, variables))
    port_q = quantize_retinaface(port_float, SIZE, device="cpu")
    port_on_jax_tree = weights.load_model(family, weights.state_dict_from_jax(family, qvars))
    return dict(backbone=backbone, family=family, model=model, variables=variables, qmodel=qmodel,
                qvars=qvars, port_float=port_float, port_q=port_q, port_on_jax_tree=port_on_jax_tree)


@pytest.fixture(scope="module")
def mnet_q():
    return _quantized("mobilenet025")


@pytest.fixture(scope="module")
def r50_q():
    return _quantized("resnet50")


@pytest.fixture(params=list(FAMILIES))
def quantized(request):
    """Each backbone's build, made once per module."""
    return request.getfixturevalue({"mobilenet025": "mnet_q", "resnet50": "r50_q"}[request.param])


# ---------------------------------------------------------------------------
# One conv, on identical inputs: exact.
# ---------------------------------------------------------------------------

LAYERS = {
    "1x1_s1": ((1, 1, 32, 16), (1, 1), ((0, 0), (0, 0)), (2, 9, 7)),
    "1x1_s2": ((1, 1, 16, 24), (2, 2), ((0, 0), (0, 0)), (2, 9, 7)),
    "3x3_s1": ((3, 3, 16, 32), (1, 1), ((1, 1), (1, 1)), (2, 9, 7)),
    "3x3_s2": ((3, 3, 16, 32), (2, 2), ((1, 1), (1, 1)), (2, 9, 7)),
    "3x3_s2_k27": ((3, 3, 3, 8), (2, 2), ((1, 1), (1, 1)), (2, 16, 16)),
    "s2d_stem_4x4_pad21": ((4, 4, 12, 64), (1, 1), ((2, 1), (2, 1)), (2, 8, 8)),
}


@pytest.mark.parametrize("case", list(LAYERS))
def test_int8_conv_layer_equals_jax(case):
    """Codes, int32 accumulators and f32 outputs equal JAX's Int8Conv bit for
    bit; the K = 27 case pads K to 32, the 1x1/s2 and stem cases go through
    the strided gather, the stem with its (2, 1) block padding."""
    shape, stride, padding, (b, h, w) = LAYERS[case]
    rng = np.random.default_rng(len(case))
    q, s = jquant.quantize_array(rng.normal(0, 0.1, shape).astype(np.float32))
    s = s.reshape(-1)
    x = rng.normal(0, 2.0, (b, h, w, shape[2])).astype(np.float32)
    amax = np.float32(0.8) * np.abs(x).max()  # some codes clip at +-127
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2)

    sx = jnp.maximum(jnp.float32(amax), jnp.float32(1e-8)) / 127.0
    want_codes = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / sx), -127, 127).astype(jnp.int8))
    codes = int8_conv.quantize_activation(x_t, torch.tensor(amax))
    np.testing.assert_array_equal(_nhwc(codes), want_codes)
    assert (np.abs(want_codes) == 127).any()

    want_acc = jax.lax.conv_general_dilated(
        jnp.asarray(want_codes), jnp.asarray(q), stride, padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
    )
    acc = int8_conv.int8_conv2d(codes, torch.from_numpy(np.ascontiguousarray(q.transpose(3, 2, 0, 1))), stride, padding)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(_nhwc(acc), np.asarray(want_acc))

    mod = Int8Conv(shape[3], shape[:2], stride, padding=padding)
    want = mod.apply({"params": {"kernel_q": jnp.asarray(q), "kernel_scale": jnp.asarray(s)}},
                     jnp.asarray(x), jnp.float32(amax))
    with torch.no_grad():
        got = _act_conv(q, s, stride, padding, amax)(x_t)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_int8_conv_exact_on_grid():
    """tests/test_quantize.py's grid test: weights and activations on the
    int8 grid, so the int8 conv equals the float conv up to f32 summation
    order (JAX's bound, rtol 1e-5, atol 1e-4), and equals JAX's Int8Conv
    bit for bit."""
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, (3, 3, 4, 8)).astype(np.int8)
    s = (0.01 * (1 + np.arange(8))).astype(np.float32)
    xq = rng.integers(-127, 128, (1, 6, 6, 4)).astype(np.float32)
    sx = 0.5
    x = xq * sx
    want = Int8Conv(8, (3, 3)).apply(
        {"params": {"kernel_q": jnp.asarray(q), "kernel_scale": jnp.asarray(s)}}, jnp.asarray(x), jnp.float32(127 * sx)
    )
    with torch.no_grad():
        got = _act_conv(q, s, amax=127 * sx)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(q.astype(np.float32) * s), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_int8_conv_calibration_records_amax():
    """tests/test_quantize.py's calibration test on ConvBN(8, (3, 3),
    quant=True): amax is max |x| exactly, and the calibration forward (f32
    on the dequantized weights, then BatchNorm and ReLU) is JAX's within
    1e-5; amax only grows over batches."""
    x = np.random.default_rng(1).normal(0, 3, (1, 6, 6, 4)).astype(np.float32)
    mod = ConvBN(8, (3, 3), quant=True)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    qv = jquant.quantize_model_variables(mod, {"params": {"Conv_0": {"kernel": np.random.default_rng(2).normal(
        0, 0.2, (3, 3, 4, 8)).astype(np.float32)}, "BatchNorm_0": variables["params"]["BatchNorm_0"]},
        "batch_stats": variables["batch_stats"]}, jnp.asarray(x))
    want, upd = mod.apply(qv, jnp.asarray(x), mutable=["quant_stats"])
    amax = float(jax.tree.leaves(upd["quant_stats"])[0])
    assert amax == float(np.abs(x).max())

    port = conv_bn(4, 8, 3, negative_slope=0.0)
    port[0].weight.data.copy_(torch.from_numpy(np.asarray(qv["params"]["Conv_0"]["kernel_q"], np.float32)
                                               * np.asarray(qv["params"]["Conv_0"]["kernel_scale"])).permute(3, 2, 0, 1))
    quantize_activations(port.eval())
    np.testing.assert_array_equal(port[0].weight_q.permute(2, 3, 1, 0).numpy(), qv["params"]["Conv_0"]["kernel_q"])
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2)
    calibrate(port, [x_t])
    assert float(port[0].amax) == amax
    with torch.no_grad():
        port[0].calibrating = True
        got = port(x_t)
        port[0].calibrating = False
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    calibrate(port, [x_t / 2])
    assert float(port[0].amax) == amax
    calibrate(port, [x_t * 2])
    assert float(port[0].amax) == 2 * amax


# ---------------------------------------------------------------------------
# The whole RetinaFace.
# ---------------------------------------------------------------------------


def test_swap_count_and_paths(quantized):
    """quantize_activations swaps 34 convs of the MobileNet-0.25 and 73 of
    the ResNet-50, one to one with JAX's ``kernel_q`` paths through the
    family's map; depthwise convs and the heads stay float."""
    backbone, family = quantized["backbone"], quantized["family"]
    swapped = {name for name, m in quantized["port_q"].named_modules() if isinstance(m, Int8ActConv2d)}
    assert len(swapped) == N_INT8[backbone]
    target = jax.eval_shape(lambda: quantized["qmodel"].init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    from flax import traverse_util

    jax_paths = {"params/" + "/".join(k[:-1]) + "/kernel" for k in traverse_util.flatten_dict(target["params"])
                 if k[-1] == "kernel_q"}
    assert len(jax_paths) == N_INT8[backbone]
    mapping = weights.mapping_for(family)
    assert {mapping[p][0] for p in jax_paths} == swapped
    floats = [m for m in quantized["port_q"].modules() if type(m) is nn.Conv2d]
    assert all(m.groups > 1 or m.bias is not None for m in floats)
    assert quantized["port_q"].quant and not quantized["port_float"].quant


def test_quantize_retinaface_tree_equals_jax(quantized):
    """The port's quantize_retinaface (default calibration, on the CPU): q
    and scales equal JAX's, every amax within rtol 1e-5 and > 0; the float
    model is left untouched."""
    want = weights.state_dict_from_jax(quantized["family"], quantized["qvars"])
    got = quantized["port_q"].state_dict()
    assert set(got) == set(want)
    n_amax = 0
    for key, ref in want.items():
        if key.endswith((".weight_q", ".weight_scale")):
            assert got[key].dtype == ref.dtype and torch.equal(got[key], ref), key
        elif key.endswith(".amax"):
            n_amax += 1
            assert float(ref) > 0
            np.testing.assert_allclose(float(got[key]), float(ref), rtol=1e-5, err_msg=key)
    assert n_amax == N_INT8[quantized["backbone"]]
    assert not quantized["port_float"].quant
    assert all(p.dtype == torch.float32 for p in quantized["port_float"].parameters())


def _jax_codes(qmodel, qvars, x):
    """JAX's outputs, and the activation codes at the input of every Int8Conv
    by its module path."""
    codes = {}

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, Int8Conv) and context.method_name == "__call__":
            xin, amax = args[0], args[1]
            sx = jnp.maximum(amax, jnp.float32(1e-8)) / 127.0
            codes["/".join(context.module.path)] = np.asarray(
                jnp.clip(jnp.round(xin.astype(jnp.float32) / sx), -127, 127))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        out = qmodel.apply(qvars, jnp.asarray(x), train=False)
    return out, codes


#: Regression bounds over the measurements of the module docstring:
#: (share of flipped codes, largest code step, score, box and landmark).
WHOLE_NET_BOUNDS = {"mobilenet025": (0.001, 1, 1e-4, 5e-4), "resnet50": (0.06, 6, 0.5, 10.0)}


def test_port_on_jax_tree_holds_against_jax(quantized):
    """tests/test_quantize.py's input, (2, 64, 64, 3) uint8-range pixels,
    through the port's int8 RetinaFace on JAX's calibrated tree and JAX's
    ``qmodel.apply``: the codes at every int8 conv's input and the outputs
    within WHOLE_NET_BOUNDS."""
    backbone, family = quantized["backbone"], quantized["family"]
    x = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3)).astype(np.float32)
    out, jcodes = _jax_codes(quantized["qmodel"], quantized["qvars"], x)
    port = quantized["port_on_jax_tree"]
    pcodes = {}
    for name, mod in port.named_modules():
        if isinstance(mod, Int8ActConv2d):
            mod.register_forward_pre_hook(lambda m, a, name=name: pcodes.__setitem__(
                name, _nhwc(int8_conv.quantize_activation(a[0], m.amax)).astype(np.float32)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    mapping = weights.mapping_for(family)
    flipped = total = 0
    step = 0.0
    for path, want in jcodes.items():
        mine = pcodes[mapping[f"params/{path}/kernel"][0]]
        if path == "body/stem/Conv_0":  # the port pads the s2d input before its stem conv
            mine = mine[:, 2:-1, 2:-1]
        d = np.abs(mine - want)
        flipped, total, step = flipped + int((d > 0).sum()), total + d.size, max(step, float(d.max()))
    assert len(jcodes) == N_INT8[backbone]
    share_bound, step_bound, score_bound, px_bound = WHOLE_NET_BOUNDS[backbone]
    assert flipped / total <= share_bound and step <= step_bound, (flipped, total, step)
    for stride in (8, 16, 32):
        for key, bound in (("score", score_bound), ("bbox", px_bound), ("landmark", px_bound)):
            np.testing.assert_allclose(got[stride][key].numpy(), np.asarray(out[stride][key]), atol=bound,
                                       rtol=0, err_msg=f"{stride}/{key}")


def test_quantize_retinaface_scores_close_and_int8(mnet_q):
    """tests/test_quantize.py's test on the port (the MobileNet-0.25 at
    64x64): int8 scores within 0.05 of float, int8 weights, every amax
    recorded; the same gate holds for JAX on the same input."""
    quantized = mnet_q
    x = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3)).astype(np.float32)
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        of, oq = quantized["port_float"](x_t), quantized["port_q"](x_t)
    for stride in (8, 16, 32):
        d = (of[stride]["score"] - oq[stride]["score"]).abs().max()
        assert float(d) < 0.05, (stride, float(d))
    convs = [m for m in quantized["port_q"].modules() if isinstance(m, Int8ActConv2d)]
    assert all(m.weight_q.dtype == torch.int8 and float(m.amax) > 0 for m in convs)
    jf = quantized["model"].apply(quantized["variables"], jnp.asarray(x), train=False)
    jqo = quantized["qmodel"].apply(quantized["qvars"], jnp.asarray(x), train=False)
    for stride in (8, 16, 32):
        assert float(np.abs(np.asarray(jf[stride]["score"]) - np.asarray(jqo[stride]["score"])).max()) < 0.05


def test_bridge_carries_the_quant_tree_both_ways(quantized):
    """state_dict_from_jax and flax_from_state_dict carry a JAX quant tree
    across and back leaf for leaf (int8 stays int8); a leftover amax
    raises."""
    from flax import traverse_util

    family = quantized["family"]
    flat = {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(quantized["qvars"])).items()}
    back = weights.flax_from_state_dict(weights.mapping_for(family), quantized["port_on_jax_tree"].state_dict())
    assert set(back) == set(flat)
    for key, want in flat.items():
        assert back[key].dtype == want.dtype, key
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    extra = dict(flat)
    extra["quant_stats/extra/amax"] = np.float32(1.0)
    with pytest.raises(ValueError, match="not mapped"):
        weights.state_dict_from_jax(family, extra)
    missing = {k: v for k, v in flat.items() if not k.endswith("fpn/lateral0/amax")}
    with pytest.raises(ValueError, match="kernel_scale or quant_stats"):
        weights.state_dict_from_jax(family, missing)


def test_default_calibration_batches_are_jax_s():
    batches = default_calibration_batches((48, 32), n_calib=2, calib_batch_size=3, seed=5)
    rng = np.random.default_rng(5)
    for batch in batches:
        want = rng.integers(0, 256, (3, 32, 48, 3)).astype(np.float32)
        np.testing.assert_array_equal(_nhwc(batch), want)


# ---------------------------------------------------------------------------
# The detector.
# ---------------------------------------------------------------------------


def test_quantized_detector_pipeline_runs(r50_q, monkeypatch):
    """tests/test_quantize.py's pipeline test (R50 at 0.3, 32 candidates, 8
    rows, on uint8 frames): the port's int8 detector gives finite padded
    rows of the same shapes as JAX's ``make_batched_fn(pre_s2d=True)``
    without ever calling the fused stem (patched to raise here), and
    refuses ``stem="fused"``."""
    from rs_face_detection_tpu.configs import FaceDetectionConfig as JConfig
    from rs_face_detection_tpu.ops.image import s2d_layout_host
    from rs_face_detection_tpu.pipeline.detection import RetinaFaceDetection as JDetection
    from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
    from rs_face_detection_tpu_torch.pipeline import detection

    quantized = r50_q
    fields = dict(backbone="resnet50", image_size=SIZE, confidence_threshold=0.3, max_candidates=32,
                  max_detections=8)

    def refuse(*args, **kwargs):
        raise AssertionError("the int8 R50 called the fused stem")

    monkeypatch.setattr(detection, "fused_stem", refuse)
    det = detection.RetinaFaceDetection(FaceDetectionConfig(**fields), quantized["port_on_jax_tree"], device="cpu")
    assert det.stem_consts is None
    imgs = np.random.default_rng(2).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    out = det.detect_batch(imgs, np.ones(2, np.float32))
    assert out.det.shape == (2, 8, 5) and out.kps.shape == (2, 8, 5, 2)
    assert torch.isfinite(out.det).all() and torch.isfinite(out.kps).all()
    jdet = JDetection(JConfig(**fields), model=quantized["qmodel"], variables=quantized["qvars"])
    ref = jdet.make_batched_fn(pre_s2d=True)(jdet.variables, jnp.asarray(s2d_layout_host(imgs)), jnp.ones(2))
    assert tuple(ref.det.shape) == tuple(out.det.shape) and tuple(ref.kps.shape) == tuple(out.kps.shape)
    with pytest.raises(ValueError, match="stem='fused'"):
        detection.RetinaFaceDetection(FaceDetectionConfig(**fields), quantized["port_on_jax_tree"], device="cpu",
                                      stem="fused")
    float_det = detection.RetinaFaceDetection(FaceDetectionConfig(**fields), quantized["port_float"], device="cpu")
    with pytest.raises(AssertionError, match="fused stem"):
        float_det.detect_batch(imgs, np.ones(2, np.float32))


@pytest.fixture(scope="module")
def trained_int8():
    """The trained 64-px MobileNet-0.25 (``trained_mnet64.npz``) quantized
    by JAX's quantize_retinaface, as JAX's detector and as the port's
    detector on the bridged tree, at tests/test_torch_serving.py's
    settings."""
    from rs_face_detection_tpu.configs import FaceDetectionConfig as JConfig
    from rs_face_detection_tpu.models.retinaface import RetinaFace as JRetinaFace
    from rs_face_detection_tpu.pipeline.detection import RetinaFaceDetection as JDetection
    from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
    from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
    from flax import traverse_util

    family = "retinaface_mobilenet025"
    fields = dict(image_size=SIZE, confidence_threshold=0.3, max_candidates=64, max_detections=8)
    with np.load(os.path.join(FIXTURES, "trained_mnet64.npz")) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    variables = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    qmodel, qvars = jquant.quantize_retinaface(JRetinaFace(backbone="mobilenet025"), variables, SIZE)
    jdet = JDetection(JConfig(**fields), model=qmodel, variables=qvars)
    port = weights.load_model(family, weights.state_dict_from_jax(family, qvars))
    det = RetinaFaceDetection(FaceDetectionConfig(**fields), port, device="cpu")
    with np.load(os.path.join(FIXTURES, "ap_eval_set.npz")) as d:
        frames = list(d["images"][:8])
    return jdet, det, frames


def test_quantized_detect_batch_and_server_hold_against_jax(trained_int8, monkeypatch):
    """The port's int8 ``detect_batch`` on the fixture frames' canvases
    against JAX's int8 ``make_batched_fn()``, and the port's
    DetectionServer on their JPEG bytes (native loader) against JAX's
    default server: counts equal, boxes and landmarks within 1e-3 px,
    scores within 1e-5 (tests/test_torch_detection.py's bounds)."""
    cv2 = pytest.importorskip("cv2")
    from rs_face_detection_tpu.parallel.serving import DetectionServer as JDetectionServer
    from rs_face_detection_tpu_torch.serving.detection_server import DetectionServer
    from test_torch_detection import _assert_same, load_jax_native

    jdet, det, frames = trained_int8
    canvases = np.stack(frames)
    assert canvases.shape[1:] == (64, 64, 3)
    ref = jdet.make_batched_fn()(jdet.variables, jnp.asarray(canvases), jnp.ones(len(frames)))
    got = det.detect_batch(canvases, np.ones(len(frames), np.float32))
    counts = got.count.numpy()
    np.testing.assert_array_equal(counts, np.asarray(ref.count))
    assert counts.sum() >= len(frames)
    for i, n in enumerate(counts):
        _assert_same(got.det[i, :n].numpy(), got.kps[i, :n].numpy(), np.asarray(ref.det[i, :n]),
                     np.asarray(ref.kps[i, :n]))
    payloads = []
    for f in frames:
        big = cv2.resize(f, (150, 130), interpolation=cv2.INTER_LINEAR)
        ok, jpg = cv2.imencode(".jpg", big, [cv2.IMWRITE_JPEG_QUALITY, 95])
        assert ok
        payloads.append(jpg.tobytes())
    load_jax_native(monkeypatch)
    with JDetectionServer(jdet, batch_size=8) as jserver, DetectionServer(det, batch_size=8) as server:
        assert server._native is not None and jserver._native is not None, server.native_unavailable
        results, want = server.detect_batch(payloads), jserver.detect_batch(payloads)
    assert server.loader_batches == {"native": 1, "cv2": 0}
    assert sum(len(d) for d, _ in results) >= len(frames)
    for (gd, gk), (wd, wk) in zip(results, want):
        _assert_same(gd, gk, wd, wk)
