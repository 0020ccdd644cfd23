"""FDOA → emitter velocity: least squares on pairwise Doppler.

The CAF (ops/caf.py) measures per-pair differential Doppler ν_ij; at a
known (TDOA-solved) emitter position each pair's Doppler is LINEAR in
the emitter velocity v:

    ν_ij = (f_c / c) · v · (u_j − u_i)

with u_k the unit vector from the emitter to station k (ops/caf.py sign
convention: positive ν means station j receives up-shifted relative to
station i, i.e. the emitter closes on j faster). C(n,2) pairs give an
overdetermined 2D (or 3D) linear system — one small weighted lstsq, no
iteration. This turns the tracker's differentiated-position velocity
(lagging, noisy) into an instantaneous per-window measurement.

The reference has no moving-emitter story at all (its integration plan,
snr_analysis.go:83-88, silently assumes zero Doppler).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from tdoa_tpu_torch.utils.constants import SPEED_OF_LIGHT


class VelocitySolution(NamedTuple):
    vel_enu: np.ndarray  # [3] m/s (vz = 0 unless solve_z)
    residual_hz: float  # rms Doppler residual of the fit
    speed: float  # |vel| m/s
    # 1σ velocity standard errors per solved axis (m/s), by linear
    # propagation of the Doppler noise through (AᵀWA)⁻¹. Velocity-DOP
    # is often large (tens of m/s per Hz of FDOA error) — a small
    # residual does NOT mean a precise velocity; always read this.
    sigma_enu: Optional[np.ndarray] = None


def solve_velocity_enu(
    stations_enu: np.ndarray,  # [n, 3]
    pair_idx: np.ndarray,  # [m, 2]
    pos_enu: np.ndarray,  # [3] emitter position (from the TDOA fix)
    fdoa_hz: np.ndarray,  # [m] differential Doppler per pair
    carrier_hz: float,
    weights: Optional[np.ndarray] = None,
    solve_z: bool = False,
    fdoa_sigma_hz: Optional[float] = None,
    fdoa_sigma_floor_hz: float = 0.0,
) -> VelocitySolution:
    """Weighted least-squares emitter velocity from pairwise FDOA.

    ``fdoa_sigma_hz``: per-measurement 1σ Doppler error for the
    velocity covariance; defaults to the dof-corrected fit residual
    of the WEIGHTED system (so covariance and normal matrix share one
    scale whatever the weights), never below ``fdoa_sigma_floor_hz``
    (e.g. the measurement's sub-bin interpolation accuracy). When an
    explicit ``fdoa_sigma_hz`` is combined with quality-ratio weights
    (max-normalized to 1, not 1/σ²), sigma_enu is an upper bound:
    downweighting deflates AᵀWA, inflating the covariance.
    """
    st = np.asarray(stations_enu, np.float64)
    p = np.asarray(pos_enu, np.float64)
    u = st - p[None, :]  # emitter → station
    u = u / np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-9)
    du = u[pair_idx[:, 1]] - u[pair_idx[:, 0]]  # [m, 3]
    n_dim = 3 if solve_z else 2
    a = (carrier_hz / SPEED_OF_LIGHT) * du[:, :n_dim]
    b = np.asarray(fdoa_hz, np.float64)
    aw, bw = a, b
    if weights is not None:
        w = np.sqrt(np.maximum(np.asarray(weights, np.float64), 0.0))
        aw = a * w[:, None]
        bw = b * w
    v, *_ = np.linalg.lstsq(aw, bw, rcond=None)
    vel = np.zeros(3)
    vel[:n_dim] = v
    # Residual on the UNWEIGHTED system so it stays in Hz and is
    # comparable against CAF measurement noise whatever the weights.
    resid = float(np.sqrt(np.mean((a @ v - b) ** 2))) if len(b) else 0.0
    sigma_enu = None
    m = len(b)
    if m > n_dim:
        if fdoa_sigma_hz is None:
            # Weighted residual: cov below uses inv(AᵀWA), so the noise
            # estimate must live in the same weighted scale — the
            # unweighted rms would mis-scale sigma under downweighting.
            rw = aw @ v - bw
            fdoa_sigma_hz = float(np.sqrt(np.sum(rw**2) / (m - n_dim)))
        fdoa_sigma_hz = max(fdoa_sigma_hz, fdoa_sigma_floor_hz)
        try:
            cov = np.linalg.inv(aw.T @ aw) * fdoa_sigma_hz**2
            sig = np.zeros(3)
            sig[:n_dim] = np.sqrt(np.maximum(np.diag(cov), 0.0))
            sigma_enu = sig
        except np.linalg.LinAlgError:
            sigma_enu = np.full(3, np.inf)
    return VelocitySolution(
        vel_enu=vel, residual_hz=resid, speed=float(np.linalg.norm(vel)),
        sigma_enu=sigma_enu,
    )


def expected_fdoa_hz(
    stations_enu: np.ndarray,
    pair_idx: np.ndarray,
    pos_enu: np.ndarray,
    vel_enu: np.ndarray,
    carrier_hz: float,
) -> np.ndarray:
    """Forward model (the exact inverse of solve_velocity_enu) — for
    simulation truth tables and residual checks."""
    st = np.asarray(stations_enu, np.float64)
    u = st - np.asarray(pos_enu, np.float64)[None, :]
    u = u / np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-9)
    du = u[pair_idx[:, 1]] - u[pair_idx[:, 0]]
    return (carrier_hz / SPEED_OF_LIGHT) * (du @ np.asarray(vel_enu))


def station_doppler_from_pairs(
    pair_idx: np.ndarray,  # [m, 2]
    fdoa_hz: np.ndarray,  # [m] pairwise differential Doppler
    n_stations: int,
) -> np.ndarray:
    """Per-station received-frequency shifts from pairwise FDOA.

    ν_ij = s_j − s_i determines s only up to a common constant (the
    gauge); the minimum-norm least-squares solution is returned. Used
    for deramp-and-correlate: counter-rotating each station's signal by
    its own s_k cancels the pairwise Doppler so the plain correlator's
    full sub-sample machinery applies to a moving emitter.
    """
    m = len(pair_idx)
    a = np.zeros((m, n_stations))
    a[np.arange(m), pair_idx[:, 1]] = 1.0
    a[np.arange(m), pair_idx[:, 0]] = -1.0
    s, *_ = np.linalg.lstsq(a, np.asarray(fdoa_hz, np.float64), rcond=None)
    return s - s.mean()  # fix the gauge at zero-mean
