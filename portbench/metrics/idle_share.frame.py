"""idle_share.frame: the device's idle share over a traced stretch of the
mix (devtrace.py), beside frame_p95_ms: 1 - (the union of its device
events' time / the span from the first one's start to the last one's end),
in percent."""


def read(run):
    prof = run["profile"]
    if not prof or prof["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["span_s"])
