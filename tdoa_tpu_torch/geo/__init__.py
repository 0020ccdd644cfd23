from tdoa_tpu_torch.geo.wgs84 import (
    lla_to_ecef,
    ecef_to_lla,
    ecef_to_enu,
    enu_to_ecef,
    lla_to_enu,
    enu_to_lla,
    network_origin,
    baselines,
    pairwise_distances,
)

__all__ = [
    "lla_to_ecef",
    "ecef_to_lla",
    "ecef_to_enu",
    "enu_to_ecef",
    "lla_to_enu",
    "enu_to_lla",
    "network_origin",
    "baselines",
    "pairwise_distances",
]
