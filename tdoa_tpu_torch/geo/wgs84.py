"""WGS84 geodesy: LLA ↔ ECEF ↔ local ENU.

Host-side float64 numpy: station geometry is a handful of points, so
precision matters more than throughput here. The device-side solver works
in a local east-north-up frame produced by these transforms, where float32
is accurate to millimetres over 100 km extents.

Reference semantics: latLonToECEF / distance3D / calculateBaseline at
processor.go:125-163 and the iterative ecefToLatLon at
processor.go:1023-1045 (this implementation iterates to convergence rather
than a fixed 5 passes).
"""

from __future__ import annotations

import numpy as np

from tdoa_tpu_torch.utils.constants import WGS84_A, WGS84_E2


def lla_to_ecef(lla: np.ndarray) -> np.ndarray:
    """(lat°, lon°, elev m) → ECEF (x, y, z) meters. Works on [..., 3]."""
    lla = np.asarray(lla, dtype=np.float64)
    lat = np.radians(lla[..., 0])
    lon = np.radians(lla[..., 1])
    h = lla[..., 2]
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat**2)
    x = (n + h) * cos_lat * np.cos(lon)
    y = (n + h) * cos_lat * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + h) * sin_lat
    return np.stack([x, y, z], axis=-1)


def ecef_to_lla(ecef: np.ndarray, iters: int = 8) -> np.ndarray:
    """ECEF (x, y, z) m → (lat°, lon°, elev m) via iterative latitude
    refinement (same scheme as processor.go:1023-1045, more iterations)."""
    ecef = np.asarray(ecef, dtype=np.float64)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    # Division-free height h = p·cosφ + z·sinφ − N(1−e²sin²φ): exact for
    # the true φ (combine p=(N+h)cosφ and z=(N(1−e²)+h)sinφ) and, unlike
    # p/cosφ − N, well-behaved at the poles where p → 0.
    def height(lat_):
        s, c = np.sin(lat_), np.cos(lat_)
        n_ = WGS84_A / np.sqrt(1.0 - WGS84_E2 * s**2)
        return n_, p * c + z * s - n_ * (1.0 - WGS84_E2 * s**2)

    for _ in range(iters):
        n, h = height(lat)
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    _, h = height(lat)
    return np.stack([np.degrees(lat), np.degrees(lon), h], axis=-1)


def _enu_rotation(lat_deg: float, lon_deg: float) -> np.ndarray:
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    # Rows: east, north, up unit vectors in ECEF.
    return np.array(
        [
            [-so, co, 0.0],
            [-sl * co, -sl * so, cl],
            [cl * co, cl * so, sl],
        ]
    )


def ecef_to_enu(ecef: np.ndarray, origin_lla: np.ndarray) -> np.ndarray:
    """ECEF points → local ENU meters around ``origin_lla`` (lat°, lon°, h)."""
    origin_lla = np.asarray(origin_lla, dtype=np.float64)
    r = _enu_rotation(origin_lla[0], origin_lla[1])
    d = np.asarray(ecef, dtype=np.float64) - lla_to_ecef(origin_lla)
    return d @ r.T


def enu_to_ecef(enu: np.ndarray, origin_lla: np.ndarray) -> np.ndarray:
    origin_lla = np.asarray(origin_lla, dtype=np.float64)
    r = _enu_rotation(origin_lla[0], origin_lla[1])
    return np.asarray(enu, dtype=np.float64) @ r + lla_to_ecef(origin_lla)


def lla_to_enu(lla: np.ndarray, origin_lla: np.ndarray) -> np.ndarray:
    return ecef_to_enu(lla_to_ecef(lla), origin_lla)


def enu_to_lla(enu: np.ndarray, origin_lla: np.ndarray) -> np.ndarray:
    return ecef_to_lla(enu_to_ecef(enu, origin_lla))


def pairwise_distances(ecef: np.ndarray) -> np.ndarray:
    """All-pairs 3D distance matrix [n, n] (distance3D, processor.go:150-156)."""
    d = ecef[:, None, :] - ecef[None, :, :]
    return np.sqrt((d**2).sum(-1))


def baselines(lla: np.ndarray):
    """Upper-triangle station baselines as ((i, j), meters) pairs
    (calculateBaseline, processor.go:159-163)."""
    ecef = lla_to_ecef(lla)
    dm = pairwise_distances(ecef)
    n = dm.shape[0]
    return [((i, j), float(dm[i, j])) for i in range(n) for j in range(i + 1, n)]


def network_origin(station_lla: np.ndarray) -> np.ndarray:
    """Mean station position as an ENU origin, with a CIRCULAR mean for
    longitude — an arithmetic mean of raw degrees puts the origin on the
    wrong side of the planet for a network straddling the ±180°
    antimeridian. Single home for the convention (solver, tracker, and
    coverage map must agree on the frame)."""
    lla = np.asarray(station_lla, dtype=np.float64)
    lon_rad = np.radians(lla[:, 1])
    mean_lon = np.degrees(
        np.arctan2(np.sin(lon_rad).mean(), np.cos(lon_rad).mean())
    )
    return np.array([lla[:, 0].mean(), mean_lon, lla[:, 2].mean()])
