"""Heads milliseconds per face (served cells): the fused tail (warp, quality
and embedding) as the registry counts ``face_identification``, cumulative
duration over inferences over the window."""

UNIT = "ms/face"


def read(ctx):
    reg = ctx.get("registry")
    if reg is None or reg["identification"]["inferences"] <= 0:
        return None
    return 1e3 * reg["identification"]["seconds"] / reg["identification"]["inferences"]
