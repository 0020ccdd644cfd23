"""fix_s: the measured window's wall time over the windows it completed
(capture files → fix, per window; host clock)."""


def read(run):
    return run.window_s / len(run.latencies) if run.latencies else None
