"""The device's idle share in the traced sub-window (bulk cells): one less
the union of its kernels', copies' and sets' intervals over the sub-window's
wall time."""

UNIT = "%"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
