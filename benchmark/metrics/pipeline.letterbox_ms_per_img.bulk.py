"""Milliseconds per image of the ``pipeline.letterbox`` spans (pinning, uploads
and resize launches of ``letterbox_u8_batch``) under ``pipeline.extract_batch`` (bulk cells), in the traced sub-window."""

from benchmark import spans

UNIT = "ms/img"


def read(ctx):
    try:
        from rs_face_detection_tpu_torch.utils import tracing
    except ImportError:  # a program without its own spans
        return None
    return spans.stage_ms_per(tracing.read(), "pipeline.letterbox", "images")
