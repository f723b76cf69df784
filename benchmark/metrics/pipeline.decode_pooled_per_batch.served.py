"""Images decoded on the pool of host threads per ``FacePipeline.extract_batch``:
the ``decode_pooled`` counter of each ``pipeline.extract_batch`` span (served cells), in the traced
sub-window.  None where no batch holds the counter: a program that decodes on one thread."""

from benchmark import spans

UNIT = "img/batch"


def read(ctx):
    try:
        from rs_face_detection_tpu_torch.utils import tracing
    except ImportError:  # a program without its own spans
        return None
    snap = tracing.read()
    if not any("decode_pooled" in s.counts for s in snap.spans if s.name == spans.BATCH):
        return None
    return spans.count_per_batch(snap, "decode_pooled")
