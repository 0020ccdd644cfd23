"""latency_p90_s: the 90th percentile of all per-window latencies of the
run (host clock, the card synchronised). Read per layer: its level moves
too far from one run to the next to hold a bound end to end."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 90)) if run.latencies else None
