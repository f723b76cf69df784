"""Host time per image inside ``FacePipeline.extract_batch``, less the
registry's detector and heads durations (served cells): decode, letterbox
upload, selection, alignment and the result's assembly.  The time inside
extract_batch is the batcher's cumulative compute seconds."""

UNIT = "ms/img"


def read(ctx):
    total = ctx.get('compute_s')
    reg, n = ctx.get("registry"), ctx.get("images", 0)
    if total is None or reg is None or n <= 0:
        return None
    return 1e3 * (total - reg["detector"]["seconds"] - reg["identification"]["seconds"]) / n
