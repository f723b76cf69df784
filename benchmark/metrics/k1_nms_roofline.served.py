"""K1's share of its roofline in the traced sub-window (served cells): the
bound of counts/k1.py over the device time of ``nms_mask_kernel``."""

from benchmark.counts import k1
from benchmark.trace import kernel_seconds

UNIT = "%"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    seconds, n = kernel_seconds(tr, "nms_mask_kernel")
    return k1.roofline(tr["launches"].get("k1"), seconds, n)
