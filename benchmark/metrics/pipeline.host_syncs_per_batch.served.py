"""Calls that block the host on the stream per ``FacePipeline.extract_batch``:
the ``host_syncs`` counter of each ``pipeline.extract_batch`` span (served cells), in the traced sub-window."""

from benchmark import spans

UNIT = "syncs/batch"


def read(ctx):
    try:
        from rs_face_detection_tpu_torch.utils import tracing
    except ImportError:  # a program without its own spans
        return None
    return spans.count_per_batch(tracing.read(), "host_syncs")
