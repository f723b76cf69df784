"""K2's share of its roofline in the traced sub-window (served cells of the
ResNet-50): the bound of counts/k2.py over the device time of
``fused_stem_kernel``."""

from benchmark.counts import k2
from benchmark.trace import kernel_seconds

UNIT = "%"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    seconds, n = kernel_seconds(tr, "fused_stem_kernel")
    return k2.roofline(tr["launches"].get("k2"), seconds, n)
