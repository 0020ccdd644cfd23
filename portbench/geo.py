"""WGS84 geodesy in float64 numpy: LLA ↔ ECEF ↔ local ENU.

A frozen copy of the formulas the port uses (the collector's
processor.go:125-163 and 1023-1045), kept here so that the scene
generator and the plain reference depend on nothing of the program."""

from __future__ import annotations

import numpy as np

SPEED_OF_LIGHT = 299_792_458.0  # m/s
WGS84_A = 6_378_137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = 2 * WGS84_F - WGS84_F * WGS84_F


def lla_to_ecef(lla) -> np.ndarray:
    """(lat°, lon°, elev m) [..., 3] → ECEF metres [..., 3]."""
    lla = np.asarray(lla, dtype=np.float64)
    lat, lon, h = np.radians(lla[..., 0]), np.radians(lla[..., 1]), lla[..., 2]
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    return np.stack([(n + h) * np.cos(lat) * np.cos(lon),
                     (n + h) * np.cos(lat) * np.sin(lon),
                     (n * (1.0 - WGS84_E2) + h) * np.sin(lat)], axis=-1)


def ecef_to_lla(ecef, iters: int = 8) -> np.ndarray:
    """ECEF metres [..., 3] → (lat°, lon°, elev m), latitude iterated."""
    ecef = np.asarray(ecef, dtype=np.float64)
    x, y, z = ecef[..., 0], ecef[..., 1], ecef[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))

    def height(lat_):
        s, c = np.sin(lat_), np.cos(lat_)
        n_ = WGS84_A / np.sqrt(1.0 - WGS84_E2 * s ** 2)
        return n_, p * c + z * s - n_ * (1.0 - WGS84_E2 * s ** 2)

    for _ in range(iters):
        n, h = height(lat)
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    _, h = height(lat)
    return np.stack([np.degrees(lat), np.degrees(lon), h], axis=-1)


def _rotation(lat_deg: float, lon_deg: float) -> np.ndarray:
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    sl, cl, so, co = np.sin(lat), np.cos(lat), np.sin(lon), np.cos(lon)
    return np.array([[-so, co, 0.0],
                     [-sl * co, -sl * so, cl],
                     [cl * co, cl * so, sl]])


def lla_to_enu(lla, origin) -> np.ndarray:
    origin = np.asarray(origin, dtype=np.float64)
    d = lla_to_ecef(lla) - lla_to_ecef(origin)
    return d @ _rotation(origin[0], origin[1]).T


def enu_to_lla(enu, origin) -> np.ndarray:
    origin = np.asarray(origin, dtype=np.float64)
    ecef = (np.asarray(enu, dtype=np.float64) @ _rotation(origin[0], origin[1])
            + lla_to_ecef(origin))
    return ecef_to_lla(ecef)


def network_origin(station_lla) -> np.ndarray:
    """Mean station position, the longitude a circular mean: the frame
    in which the fix is solved."""
    lla = np.asarray(station_lla, dtype=np.float64)
    lon = np.radians(lla[:, 1])
    mean_lon = np.degrees(np.arctan2(np.sin(lon).mean(), np.cos(lon).mean()))
    return np.array([lla[:, 0].mean(), mean_lon, lla[:, 2].mean()])


def horizontal_m(a_lla, b_lla, origin) -> float:
    """East-north distance in metres between two (lat, lon, elev) points."""
    d = lla_to_enu(np.asarray(a_lla), origin) - lla_to_enu(np.asarray(b_lla),
                                                           origin)
    return float(np.hypot(d[0], d[1]))
