"""Milliseconds of a served Extract's own work on its gRPC handler thread
(the request's submit and the reply's encoding): each ``runtime.extract``
span less its ``runtime.wait`` child, the wait on the dynamic batcher,
averaged over the traced sub-window's requests."""

from benchmark import spans

UNIT = "ms"


def read(ctx):
    try:
        from rs_face_detection_tpu_torch.utils import tracing
    except ImportError:  # a program without its own spans
        return None
    return spans.self_ms(tracing.read(), "runtime.extract", "runtime.wait")
