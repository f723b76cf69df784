"""Device milliseconds per face of the fused tail (warp, quality and embedding
heads): the CUDA events of the ``heads`` spans under
``pipeline.extract_batch``, over the faces of their batches (served cells), in the traced sub-window."""

from benchmark import spans

UNIT = "ms/face"


def read(ctx):
    try:
        from rs_face_detection_tpu_torch.utils import tracing
    except ImportError:  # a program without its own spans
        return None
    return spans.stage_ms_per(tracing.read(), "heads", "faces", device=True)
