"""Milliseconds a served request waits in the dynamic batcher's queue before
its batch starts: the change over the window of the batcher's cumulative
queue seconds over its requests (``DynamicBatcher.stats()``, read through
the ServerMetadata verb)."""

UNIT = "ms"


def read(ctx):
    b = ctx.get("batcher")
    if b is None or b["requests"] <= 0:
        return None
    return 1e3 * b["queue_s"] / b["requests"]
