"""The 95th percentile of the window's requests, from each one's due time to
its reply (a failed one counts as the drain deadline).  Above the knee the
queue grows all through the window, so it swings with the smallest change
in capacity: a reading beside ``extract_req_per_s``, not a bound."""

UNIT = "ms"


def read(ctx):
    return ctx.get("latency_p95_ms")
