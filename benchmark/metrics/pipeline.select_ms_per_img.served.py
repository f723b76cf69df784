"""Milliseconds per image of the ``pipeline.select`` spans (selection, the
alignment matrices and their upload, the crop fallback's staging) under
``pipeline.extract_batch`` (served cells), in the traced sub-window."""

from benchmark import spans

UNIT = "ms/img"


def read(ctx):
    try:
        from rs_face_detection_tpu_torch.utils import tracing
    except ImportError:  # a program without its own spans
        return None
    return spans.stage_ms_per(tracing.read(), "pipeline.select", "images")
