"""unspanned_ms: the mean over the traced windows of a window's latency
less the seconds of the program's stages in it, in ms: the part of a
window that no stage covers. Not clamped at zero: a stage opened inside
another counts twice and drives it below zero. Nothing without a traced
window."""


def read(run):
    got = [lat - sum(w["stages"].values())
           for lat, w in zip(run.latencies, run.windows)]
    return 1e3 * sum(got) / len(got) if got else None
