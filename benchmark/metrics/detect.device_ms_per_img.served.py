"""Device milliseconds per image of the detector: the CUDA events of the
``detect`` spans under ``pipeline.extract_batch``, from the first launch to
just before the host copies (served cells), in the traced sub-window."""

from benchmark import spans

UNIT = "ms/img"


def read(ctx):
    try:
        from rs_face_detection_tpu_torch.utils import tracing
    except ImportError:  # a program without its own spans
        return None
    return spans.stage_ms_per(tracing.read(), "detect", "images", device=True)
