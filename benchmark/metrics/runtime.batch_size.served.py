"""Requests per coalesced batch: the change over the window of the dynamic
batcher's requests over its batches."""

UNIT = "req/batch"


def read(ctx):
    b = ctx.get("batcher")
    if b is None or b["batches"] <= 0:
        return None
    return b["requests"] / b["batches"]
