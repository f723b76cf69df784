"""The whole extraction's share of the card's TF32 peak (served cells): model
FLOPs (counts/model.py) of the images and the selected faces completed in
the window, over the window, over 495 TFLOP/s."""

from benchmark.counts import TF32_FLOPS

UNIT = "%"


def read(ctx):
    f, s = ctx.get("flops"), ctx.get("window_s", 0.0)
    if f is None or s <= 0 or ctx.get("images", 0) <= 0:
        return None
    work = ctx["images"] * f["per_image"] + ctx["faces"] * f["per_face"]
    return 100.0 * work / s / TF32_FLOPS
