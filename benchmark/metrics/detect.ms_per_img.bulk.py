"""Detector milliseconds per image (bulk cells): the change over the window
of the registry's cumulative duration of ``face_detection_retina`` over its
inferences (host clock, each call ending in the copy of its results to
the host, so device time is in it)."""

UNIT = "ms/img"


def read(ctx):
    reg = ctx.get("registry")
    if reg is None or reg["detector"]["inferences"] <= 0:
        return None
    return 1e3 * reg["detector"]["seconds"] / reg["detector"]["inferences"]
