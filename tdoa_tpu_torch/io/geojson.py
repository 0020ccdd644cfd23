"""GeoJSON export: fixes, ghosts, error ellipses, emitters, tracks.

Copy of ``tdoa_tpu.io.geojson`` (numpy), on the port's ``geo`` and
``solve.multilateration``.

The reference system ends at printed lat/lon pairs the operator has to
re-type into a map; every mapping tool (Google Earth, QGIS, Leaflet,
geojson.io) ingests GeoJSON directly, so the processor and stream CLIs
can emit one FeatureCollection per result (``--geojson PATH``) with the
stations, the fix, its 1σ/3σ error ellipses, any ghost candidates, and
separated co-channel emitters.

GeoJSON coordinate order is ``[lon, lat, elev]`` (RFC 7946 §3.1.1) —
the transpose of this codebase's ``(lat, lon, elev)`` rows; every
feature goes through :func:`_coords` so the swap lives in one place.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from tdoa_tpu_torch.geo import enu_to_lla


def _coords(lat: float, lon: float, elev: float = 0.0) -> list:
    """(lat, lon, elev) -> RFC 7946 [lon, lat, elev]."""
    return [float(lon), float(lat), float(elev)]


def _point(lat, lon, elev, props: dict) -> dict:
    return {
        "type": "Feature",
        "geometry": {"type": "Point",
                     "coordinates": _coords(lat, lon, elev)},
        "properties": props,
    }


def ellipse_ring(
    center_lla: np.ndarray,  # (lat, lon, elev)
    semi_major_m: float,
    semi_minor_m: float,
    azimuth_deg: float,  # of the major axis, east of north
    k_sigma: float = 1.0,
    n_points: int = 64,
) -> List[list]:
    """Closed ``[lon, lat]`` ring of the k-sigma ellipse, built in the
    local ENU frame at the center (exact geodesy, no flat-earth
    meters-per-degree approximation)."""
    t = np.linspace(0.0, 2.0 * np.pi, n_points, endpoint=False)
    az = np.radians(azimuth_deg)
    u = np.array([np.sin(az), np.cos(az)])  # major axis, (E, N)
    # Minor axis chosen so (u, v) is right-handed: increasing t then
    # winds the exterior ring counterclockwise (RFC 7946 §3.1.6).
    v = np.array([-np.cos(az), np.sin(az)])
    en = (
        k_sigma * semi_major_m * np.cos(t)[:, None] * u[None, :]
        + k_sigma * semi_minor_m * np.sin(t)[:, None] * v[None, :]
    )
    enu = np.concatenate([en, np.zeros((len(t), 1))], axis=1)
    center = np.asarray(center_lla, np.float64)
    lla = enu_to_lla(enu, center)
    # Unwrap longitudes around the center so a ring straddling the
    # antimeridian stays continuous (values may exceed ±180 by the
    # ellipse's width — every major renderer handles that; a ±360°
    # jump mid-ring renders as a globe-wrapping polygon everywhere).
    lon = np.asarray([p[1] for p in lla])
    lon = center[1] + (lon - center[1] + 180.0) % 360.0 - 180.0
    ring = [[float(lo), float(p[0])] for lo, p in zip(lon, lla)]
    ring.append(list(ring[0]))  # exact closure, not fp coincidence
    return ring


def result_feature_collection(
    res,  # TDOAResult
    station_lla: np.ndarray,  # [n, 3] (lat, lon, elev)
    station_names,
    ref_tx_lla: Optional[np.ndarray] = None,
    lead_seconds: float = 60.0,
) -> dict:
    """One processing result as a GeoJSON FeatureCollection.

    Features: stations (+ the reference transmitter when known), the
    fix with its full numeric properties, 1σ and 3σ error-ellipse
    polygons, ghost candidates, separated co-channel emitters, and —
    when a velocity was solved — a ``lead_seconds``-long course line.
    """
    feats: List[dict] = []
    for name, row in zip(station_names, np.asarray(station_lla)):
        props = {"kind": "station", "name": str(name)}
        if res.excluded_stations and name in res.excluded_stations:
            props["excluded"] = True
        feats.append(_point(row[0], row[1], row[2], props))
    if ref_tx_lla is not None:
        r = np.asarray(ref_tx_lla, np.float64)
        feats.append(_point(r[0], r[1], r[2],
                            {"kind": "reference_tx"}))

    fix = res.fix
    props = {
        "kind": "fix",
        "rms_residual_m": float(fix.rms_residual_m),
        "warnings": list(res.warnings),
    }
    if fix.ellipse is not None:
        maj, mnr, azd = fix.ellipse
        props["ellipse_1sigma_m"] = {
            "semi_major": float(maj), "semi_minor": float(mnr),
            "azimuth_deg": float(azd),
        }
    if res.velocity_enu is not None:
        ve, vn = float(res.velocity_enu[0]), float(res.velocity_enu[1])
        props["speed_mps"] = float(np.hypot(ve, vn))
        props["heading_deg"] = float(np.degrees(np.arctan2(ve, vn)) % 360.0)
    feats.append(_point(fix.lat, fix.lon, fix.elev, props))

    if fix.ellipse is not None:
        center = np.array([fix.lat, fix.lon, fix.elev])
        maj, mnr, azd = fix.ellipse
        # Heavy-tail contour scales (confirmed echo environments): the
        # kσ confidence contour is the k·s_k ellipse of the reported
        # 1σ covariance (FixResult.conf_scales; None ⇒ Gaussian).
        scales = {1.0: 1.0, 3.0: 1.0}
        if fix.conf_scales is not None:
            scales = {1.0: float(fix.conf_scales[0]),
                      3.0: float(fix.conf_scales[2])}
        for k in (1.0, 3.0):
            feats.append({
                "type": "Feature",
                "geometry": {
                    "type": "Polygon",
                    "coordinates": [ellipse_ring(center, maj, mnr, azd,
                                                 k_sigma=k * scales[k])],
                },
                "properties": {"kind": "error_ellipse", "k_sigma": k,
                               "radial_scale": scales[k]},
            })

    if fix.candidates_lla is not None and len(fix.candidates_lla) > 1:
        for k, cand in enumerate(np.asarray(fix.candidates_lla)[1:], 1):
            p = {"kind": "ghost_candidate",
                 "rms_residual_m": float(fix.candidates_rms[k])}
            if fix.candidates_power_score is not None:
                p["power_score"] = float(fix.candidates_power_score[k])
            feats.append(_point(cand[0], cand[1], cand[2], p))

    if res.emitters is not None and len(res.emitters) > 1:
        for n_e, e in enumerate(res.emitters):
            p = {
                "kind": "emitter",
                "index": n_e,
                "rms_residual_m": float(e.fix.rms_residual_m),
                "max_inconsistency_samples": float(
                    e.max_inconsistency_samples),
            }
            feats.append(_point(e.fix.lat, e.fix.lon, e.fix.elev, p))

    if res.velocity_enu is not None:
        v = np.asarray(res.velocity_enu, np.float64)
        lead = enu_to_lla(
            np.array([v[0], v[1], 0.0]) * lead_seconds,
            np.array([fix.lat, fix.lon, fix.elev]),
        )
        # Keep the line continuous across the antimeridian (see
        # ellipse_ring).
        lead_lon = fix.lon + (float(lead[1]) - fix.lon + 180.0) % 360.0 - 180.0
        feats.append({
            "type": "Feature",
            "geometry": {
                "type": "LineString",
                "coordinates": [
                    _coords(fix.lat, fix.lon, fix.elev),
                    _coords(lead[0], lead_lon, fix.elev),
                ],
            },
            "properties": {"kind": "course",
                           "lead_seconds": float(lead_seconds)},
        })
    return {"type": "FeatureCollection", "features": feats}


def tracks_feature_collection(
    tracker,  # pipeline.streaming.TargetTracker
    station_lla: np.ndarray,
    station_names,
    history: Optional[dict] = None,  # id -> [[lat, lon], ...] trail
) -> dict:
    """Live track snapshot: stations, one Point per track (position,
    velocity, update/coast counters), and an optional per-track trail
    LineString from ``history`` (lat/lon rows, oldest first)."""
    feats: List[dict] = []
    for name, row in zip(station_names, np.asarray(station_lla)):
        feats.append(_point(row[0], row[1], row[2],
                            {"kind": "station", "name": str(name)}))
    for tid, tr in tracker.tracks.items():
        lla = tr.lla(tracker.origin)
        ve, vn = float(tr.vel_enu[0]), float(tr.vel_enu[1])
        props = {
            "kind": "track",
            "id": str(tid),
            "speed_mps": float(np.hypot(ve, vn)),
            "heading_deg": float(np.degrees(np.arctan2(ve, vn)) % 360.0),
            "n_updates": int(tr.n_updates),
            "coasting": int(tr.coasts),
            "n_rejected": int(tr.n_rejected),
        }
        ell = None
        if tr.cov_p is not None:
            # The TRACK's own Kalman covariance — tighter than any one
            # window's ellipse once calibrated windows accumulate.
            from tdoa_tpu_torch.solve.multilateration import error_ellipse

            ell = error_ellipse(tr.cov_p)
            props["ellipse_1sigma_m"] = {
                "semi_major": ell[0],
                "semi_minor": ell[1],
                "azimuth_deg": ell[2],
            }
        feats.append(_point(lla[0], lla[1], lla[2], props))
        if ell is not None and ell[0] > 0:
            feats.append({
                "type": "Feature",
                "geometry": {
                    "type": "Polygon",
                    "coordinates": [ellipse_ring(lla, ell[0], ell[1],
                                                 ell[2], k_sigma=1)],
                },
                "properties": {"kind": "track_error_ellipse",
                               "id": str(tid), "k_sigma": 1},
            })
        if history and history.get(tid) and len(history[tid]) > 1:
            feats.append({
                "type": "Feature",
                "geometry": {
                    "type": "LineString",
                    "coordinates": [
                        [float(lon), float(lat)]
                        for lat, lon in history[tid]
                    ],
                },
                "properties": {"kind": "trail", "id": str(tid)},
            })
    return {"type": "FeatureCollection", "features": feats}
