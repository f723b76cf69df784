"""The port's proto3 codec (runtime/proto3.py) against the JAX package's.

  - the messages of JAX tests/test_wire.py's goldens encode to the same
    bytes in both codecs and decode to equal dicts, and the malformed
    buffers raise ValueError in both;
  - Hypothesis draws messages over every schema of the wire (ModelInfer
    requests and responses, ModelConfig with ensembles, statistics, shared
    memory, logs, traces): the two codecs' bytes are equal, and each codec
    decodes the other's bytes to the same dict.
"""

import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rs_face_detection_tpu.runtime import proto3 as jproto3
from rs_face_detection_tpu.runtime import wire as jwire
from rs_face_detection_tpu_torch.runtime import proto3 as pproto3
from rs_face_detection_tpu_torch.runtime import wire as pwire

#: name -> (JAX schema, port schema) of every message the wire serves
SCHEMAS = {
    name: (getattr(jwire, name), getattr(pwire, name))
    for name in dir(jwire)
    if name.isupper() and isinstance(getattr(jwire, name), dict) and name not in ("DATA_TYPE", "NP_DTYPE",
                                                                                 "HEALTH_SERVING_STATUS")
}


def test_the_schemas_are_the_same():
    assert SCHEMAS and "MODEL_INFER_REQUEST" in SCHEMAS and "MODEL_CONFIG_RESPONSE" in SCHEMAS
    for name, (j, p) in SCHEMAS.items():
        assert repr(p) == repr(j), name
    assert pwire.DATA_TYPE == jwire.DATA_TYPE and pwire.NP_DTYPE == jwire.NP_DTYPE


def both_ways(schema_name, msg):
    """Encode with both codecs; each decodes both byte strings alike."""
    js, ps = SCHEMAS[schema_name] if isinstance(schema_name, str) else schema_name
    jb, pb = jproto3.encode_message(js, msg), pproto3.encode_message(ps, msg)
    assert pb == jb
    jd = jproto3.decode_message(js, jb)
    assert pproto3.decode_message(ps, jb) == jd
    return jb, jd


GOLDEN_SCHEMA = {"name": (1, "string"), "shape": (3, "int64", True)}


def schema_pair(spec):
    """{name: (number, kind[, repeated])} -> (JAX schema, port schema)."""
    return ({k: jproto3.Field(*v) for k, v in spec.items()}, {k: pproto3.Field(*v) for k, v in spec.items()})


@pytest.mark.parametrize(
    "schema, msg, golden",
    [
        ("SERVER_LIVE_RESPONSE", {"live": True}, b"\x08\x01"),
        ("SERVER_LIVE_RESPONSE", {"live": False}, b""),
        (schema_pair(GOLDEN_SCHEMA), {"name": "ab", "shape": [1, 300]}, b"\x0a\x02ab\x1a\x03\x01\xac\x02"),
        (schema_pair({"v": (1, "int64")}), {"v": -2}, b"\x08\xfe" + b"\xff" * 8 + b"\x01"),
        (schema_pair({"v": (1, "int32")}), {"v": -1}, None),
        (schema_pair({"x": (6, "float", True)}), {"x": [1.0]}, b"\x32\x04" + struct.pack("<f", 1.0)),
        ("HEALTH_CHECK_RESPONSE", {"status": 1}, b"\x08\x01"),
        ("MODEL_INFER_REQUEST", {"model_name": "m", "parameters": {"max_batch_size": {"int64_param": 4}}}, None),
        ("MODEL_INFER_REQUEST", {
            "model_name": "face_detection_retina", "model_version": "", "id": "req-1",
            "inputs": [{"name": "data", "datatype": "FP32", "shape": [1, 3, 4, 4],
                        "contents": {"fp32_contents": [0.5, -1.25, 2.0]}}],
            "outputs": [{"name": "out0"}], "raw_input_contents": [b"\x01\x02"]}, None),
        ("MODEL_INFER_RESPONSE", {
            "model_name": "face_quality", "model_version": "1", "id": "",
            "outputs": [{"name": "output", "datatype": "FP32", "shape": [1, 4]}],
            "raw_output_contents": [struct.pack("<4f", 0.1, 0.2, 0.3, 0.4)]}, None),
        ("MODEL_CONFIG_RESPONSE", {"config": {
            "name": "face_detection_retina", "platform": "jax_xla", "backend": "rs_face_detection_tpu",
            "max_batch_size": 0,
            "input": [{"name": "data", "data_type": 11, "format": 2, "dims": [1, 3, 640, 640]}],
            "output": [{"name": "face_rpn_cls_prob_reshape_stride32", "data_type": 11, "dims": [1, 4, 20, 20]}]}},
         None),
        ("INFER_PARAMETER", {"bool_param": False}, b"\x08\x00"),
        ("LOG_SETTINGS_REQUEST", {"settings": {"log_info": {"bool_param": False},
                                               "log_verbose_level": {"uint32_param": 0}}}, None),
    ],
)
def test_golden_messages_encode_alike(schema, msg, golden):
    raw, _ = both_ways(schema, msg)
    if golden is not None:
        assert raw == golden


def test_packed_and_unknown_fields_decode_alike():
    js, ps = schema_pair(GOLDEN_SCHEMA)
    unpacked = b"\x0a\x02ab\x18\x01\x18\xac\x02"
    assert pproto3.decode_message(ps, unpacked) == jproto3.decode_message(js, unpacked) == {"name": "ab", "shape": [1, 300]}
    extra = b"\x08\x01\x48\x2a\x52\x03abc"
    assert pproto3.decode_message(pwire.SERVER_LIVE_RESPONSE, extra) == {"live": True}
    rng = np.random.default_rng(11)
    for n in (0, 7, 1000):
        both_ways(schema_pair({"f": (1, "float", True), "d": (2, "double", True), "v": (5, "int64", True)}),
                  {"f": rng.normal(size=n).astype(np.float32), "d": rng.normal(size=n).tolist(),
                   "v": rng.integers(-(2**31), 2**31, size=n).tolist()})


def test_malformed_buffers_raise_in_both():
    spec = {"a": (1, "int32"), "f": (4, "float"), "d": (5, "double")}
    js, ps = schema_pair(spec)
    js["m"] = jproto3.Field(2, "message", schema={"x": jproto3.Field(1, "int32")})
    ps["m"] = pproto3.Field(2, "message", schema={"x": pproto3.Field(1, "int32")})
    js["mp"] = jproto3.Field(3, "message", map_entry=(jproto3.Field(1, "string"), jproto3.Field(2, "int32")))
    ps["mp"] = pproto3.Field(3, "message", map_entry=(pproto3.Field(1, "string"), pproto3.Field(2, "int32")))
    key, varint = pproto3._key, pproto3._encode_varint
    cases = [
        b"\x08", key(9, 1), key(9, 5) + b"\x00", key(9, 2) + varint(50) + b"ab", key(4, 5) + b"\x00\x00",
        key(5, 1) + b"\x00" * 7, key(2, 0) + b"\x02\x08\x01", key(3, 0) + b"\x02\x08\x01",
        key(3, 2) + varint(100) + b"\x0a",
    ]
    for buf in cases:
        for prefix in (b"", key(1, 0) + b"\x07"):
            for codec, schema in ((jproto3, js), (pproto3, ps)):
                with pytest.raises(ValueError):
                    codec.decode_message(schema, prefix + buf)


# -- drawn messages ---------------------------------------------------------------

_INT_RANGES = {
    "int32": (-(2**31), 2**31 - 1), "int64": (-(2**63), 2**63 - 1), "uint32": (0, 2**32 - 1),
    "uint64": (0, 2**64 - 1), "enum": (0, 20), "fixed32": (0, 2**32 - 1), "fixed64": (0, 2**64 - 1),
}


def scalar(kind):
    if kind in _INT_RANGES:
        return st.integers(*_INT_RANGES[kind])
    if kind == "bool":
        return st.booleans()
    if kind == "float":
        return st.floats(width=32, allow_nan=False)
    if kind == "double":
        return st.floats(allow_nan=False)
    if kind == "string":
        return st.text(max_size=8)
    return st.binary(max_size=8)


def message(schema, depth=0):
    """A strategy of dicts over ``schema``: any subset of its fields."""
    fields = {}
    for name, f in schema.items():
        if f.map_entry is not None:
            kf, vf = f.map_entry
            value = message(vf.schema, depth + 1) if vf.kind == "message" else scalar(vf.kind)
            fields[name] = st.dictionaries(scalar(kf.kind), value, max_size=2 if depth < 2 else 0)
        elif f.kind == "message":
            sub = message(f.schema, depth + 1)
            fields[name] = st.lists(sub, max_size=2 if depth < 2 else 0) if f.repeated else sub
        elif f.repeated:
            fields[name] = st.lists(scalar(f.kind), max_size=4)
        else:
            fields[name] = scalar(f.kind)
    return st.fixed_dictionaries({}, optional=fields)


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
@pytest.mark.parametrize("schema_name", ["MODEL_INFER_REQUEST", "MODEL_INFER_RESPONSE", "MODEL_CONFIG_RESPONSE",
                                         "MODEL_STATISTICS_RESPONSE", "SHM_STATUS_RESPONSE", "LOG_SETTINGS_RESPONSE",
                                         "TRACE_SETTING_REQUEST", "MODEL_STREAM_INFER_RESPONSE",
                                         "REPOSITORY_INDEX_RESPONSE", "CUDA_SHM_REGISTER_REQUEST"])
def test_drawn_messages_encode_alike(schema_name, data):
    msg = data.draw(message(SCHEMAS[schema_name][0]))
    raw, decoded = both_ways(schema_name, msg)
    assert pproto3.decode_message(SCHEMAS[schema_name][1], raw) == decoded
