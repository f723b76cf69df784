"""The port's facade keeps the JSON error contract under hostile payloads.

The port of tests/test_server_fuzz.py against runtime/server.py::
FacePipelineServicer: every unary verb, fed each adversarial payload
straight through its handler (the gRPC layer adds nothing to payload
handling), answers JSON -- an ``{"error": ...}`` object, or the harmless
default of a verb that ignores its payload -- and never raises.  Each
answer is an error exactly where the JAX package's servicer answers one on
the same payload.  The stream reports a bad image as a JSON error and ends.
"""

import json

import pytest
import torch.nn as nn

from rs_face_detection_tpu.models.registry import ModelRegistry as JRegistry
from rs_face_detection_tpu.models.registry import ModelSpec as JSpec
from rs_face_detection_tpu.runtime.server import FacePipelineServicer as JServicer
from rs_face_detection_tpu_torch.models.registry import ModelRegistry, ModelSpec
from rs_face_detection_tpu_torch.runtime.server import FacePipelineServicer
from test_server_fuzz import PAYLOADS, UNARY_VERBS

assert len(PAYLOADS) == 21 and len(UNARY_VERBS) == 21


class _Identity(nn.Module):
    def forward(self, x):
        return x * 1.0


@pytest.fixture(scope="module")
def servicers():
    import numpy as np

    reg = ModelRegistry("cpu")
    reg.register_builder("m", lambda: (ModelSpec("m", (4,), "array"), _Identity()))
    jreg = JRegistry()

    class M:
        def apply(self, variables, x, train=False):
            return np.asarray(x) * 1.0

    jreg.register_builder("m", lambda: (JSpec("m", (4,), "array"), M(), {}))
    return FacePipelineServicer(None, reg), JServicer(None, jreg)


@pytest.mark.parametrize("verb", UNARY_VERBS)
def test_unary_verbs_never_raise(servicers, verb):
    port, jax_servicer = servicers
    handler = getattr(port, verb)
    for payload in PAYLOADS:
        try:
            out = handler(payload)
        except Exception as e:  # noqa: BLE001 -- the point of the test
            pytest.fail(f"{verb} raised on {payload[:40]!r}: {e!r}")
        decoded = json.loads(out)  # every response is JSON bytes (the wire contract)
        assert isinstance(decoded, (dict, list)), (verb, payload, decoded)
        want = json.loads(getattr(jax_servicer, verb)(payload))
        is_error = lambda d: isinstance(d, dict) and "error" in d  # noqa: E731
        assert is_error(decoded) == is_error(want), (verb, payload, decoded, want)


def test_detect_stream_bad_payloads(servicers):
    """The stream reports a JSON error and terminates: no exception."""
    chunks = list(servicers[0].detect_stream(iter([b"\x00\x01notanimage"])))
    assert chunks, "stream yielded nothing"
    assert "error" in json.loads(chunks[-1])
