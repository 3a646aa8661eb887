"""The 95th percentile of the delivered frames' latency in the traced
window, on the host's clock (as ``frame_latency_p95_ms``), for a cell whose
tail the host's copies pace: a diagnostic beside its rate, with no bound."""


def read(ctx):
    return ctx.get("latency_p95_ms")
