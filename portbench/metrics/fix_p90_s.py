"""fix_p90_s: the 90th percentile of all per-window latencies of the
measured window (host clock, the card synchronised)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 90)) if run.latencies else None
