"""fix_gap_m: the horizontal distance between the program's fix and the
reference's, in metres, in the east-north frame of the network's mean
station. Both answers carry their fix (``Answer.fix_lla``), so nothing
more is taken from the program's result."""

import numpy as np

from portbench import geo
from portbench.scene import receivers, station_lla


def gap(got, want, cfg: dict) -> float:
    origin = geo.network_origin(np.stack(
        [station_lla(cfg, n) for n in receivers(cfg)]))
    return geo.horizontal_m(got.fix_lla, want.fix_lla, origin)
