"""Unified ghost-candidate posterior: one calibrated score from the
power / FDOA / coverage-prior evidence.

A 3-station TDOA fix can have TWO timing-exact hyperbola intersections;
the residual cannot choose between them. Three independent physical
signals can: received-power consistency (1/r path loss —
`multilateration.rank_candidates_by_power`), differential-Doppler
consistency (both intersections satisfy the TDOAs but the measured
pairwise Dopplers fit one emitter velocity only at the true geometry —
`fdoa.solve_velocity_enu`), and operator knowledge (a coverage prior).
Round 3 applied them as a CASCADE of three separately-thresholded
advisory rules (prior authoritative, then FDOA with a 3× residual
margin, then power with a 0.1 log-σ margin) — 7/9 correct on the seed-
52000 soak, with each rule blind to the others' evidence.

This module replaces the cascade's DECISION with a single posterior:
each signal contributes a per-candidate log-likelihood under an
explicit error model, the total is max-normalized to log-odds, and the
fix moves only when the leader's margin over the runner-up clears a
calibrated nats threshold (`scripts/ghost_calibration.py` measures the
margin distributions for true vs ghost candidates over the Monte Carlo
ghost regimes and validates the threshold at zero wrong swaps).
Abstention is a first-class outcome: an undecided posterior keeps the
primary candidate and the ambiguity warning, never a silent coin flip.

Error models (why each σ is what it is):

- power: `rank_candidates_by_power` returns the std-dev across n_st
  stations of log(aᵢ·dᵢ) — zero iff the received amplitudes exactly
  match free-space 1/r from the candidate. Per-station log-amplitude
  mismatch (antenna patterns, ground reflections, REF-calibration
  residue) is modeled Gaussian with σ_p ≈ 0.35 nepers (measured
  ~0.1-0.3 at true candidates on the Monte Carlo soaks; ghosts read
  0.4-1.5), so ll = −n_st·score²/(2σ_p²).
- fdoa: the velocity fit's rms residual r (Hz) on dof > 0 spare
  equations; CAF sub-bin interpolation noise is ~σ_ν = 0.5 Hz, so
  ll = −dof·r²/(2σ_ν²). A candidate whose FITTED speed exceeds the
  physical ceiling additionally pays a soft quadratic barrier — the
  speed is evidence even when dof = 0 (3-station exactly-determined
  fits, where the residual is vacuous).
- prior: inside the disc costs nothing; outside pays
  −((d−R)/(0.15·R))²/2 — a candidate 0.5·R beyond the edge is ~5.6
  nats down (decisive on its own, matching the round-3 "authoritative"
  behavior), while one grazing the edge only leans.
- tdoa: the candidates' own rms residuals, ll = −m·rms²/(2σ_m²) —
  usually a wash (both intersections fit by construction) but it
  breaks degeneracy when the runner-up's fit is materially worse.

The reference has no ghost handling at all: processor.go keeps
whichever intersection its single Nelder-Mead start converges to
(processor.go:736-800) and never reports the ambiguity.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

# Calibrated on the Monte Carlo ghost population
# (scripts/ghost_calibration.py, 17 ghost-ambiguous fixes over 100
# seed-42000-base trials of the clean/noisy/wild-clocks/moving
# regimes, replayed over a (σ_p, threshold) grid): with the
# band-limited noise-floor-subtracted signal-power estimator
# (processor._station_signal_power), every grid point with
# σ_p ≤ 0.25 resolves 17/17 correctly with zero wrong swaps. The
# value is the per-station log-amplitude mismatch (≈1.3 dB) between
# the measured signal profile and free-space 1/r at the TRUE
# candidate — REF-gain-calibrated, noise floor removed, so
# antenna-pattern spread is the dominant residual; measured true-
# candidate scores on the calibration base run 0.0-0.23 (n_st = 3),
# consistent with it.
POWER_LOG_SIGMA = 0.15
FDOA_SIGMA_HZ = 0.5
# Decision threshold (nats of posterior odds, leader over runner-up).
# On the calibration base every true-leader margin exceeded 4 nats at
# σ_p 0.2 while the pre-fix WRONG-leader margins clustered below 1.5;
# 2.5 sits in the gap, validated at zero wrong swaps on two fresh
# seed bases (GHOSTCAL artifacts).
DECISION_THRESHOLD_NATS = 2.5


@dataclasses.dataclass
class GhostVerdict:
    """Posterior over the fix's candidate solutions."""

    log_odds: np.ndarray  # [k] max-normalized total log-likelihood
    best: int  # argmax of log_odds
    margin_nats: float  # leader minus runner-up
    decided: bool  # margin >= threshold
    threshold_nats: float
    # Per-signal log-likelihood arrays ([k] each), for the warning text
    # and the calibration harness: keys ⊆ {tdoa, power, fdoa, prior}.
    components: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict
    )

    def to_json(self) -> dict:
        return {
            "log_odds": [round(float(v), 3) for v in self.log_odds],
            "best": int(self.best),
            "margin_nats": round(float(self.margin_nats), 3),
            "decided": bool(self.decided),
            "threshold_nats": float(self.threshold_nats),
            "components": {
                k: [round(float(v), 3) for v in a]
                for k, a in self.components.items()
            },
        }


def ghost_posterior(
    n_candidates: int,
    *,
    rms_m: Optional[np.ndarray] = None,  # [k] per-candidate fit rms
    sigma_m: Optional[float] = None,  # scene TDOA σ scale (m)
    n_pairs_active: int = 0,
    power_scores: Optional[np.ndarray] = None,  # [k] log-σ scores
    n_stations: int = 0,
    fdoa_resid_hz: Optional[np.ndarray] = None,  # [k] rms residual
    fdoa_dof: int = 0,
    speeds_mps: Optional[np.ndarray] = None,  # [k] fitted speeds
    max_speed_mps: Optional[float] = None,
    prior_dist_m: Optional[np.ndarray] = None,  # [k] to prior center
    prior_radius_m: Optional[float] = None,
    threshold_nats: float = DECISION_THRESHOLD_NATS,
    power_log_sigma: float = POWER_LOG_SIGMA,
    fdoa_sigma_hz: float = FDOA_SIGMA_HZ,
) -> GhostVerdict:
    """Combine the available evidence into one posterior (see module
    docstring for each signal's error model). Any signal may be absent
    (None) — the posterior uses what exists; with NO evidence the
    verdict is undecided at zero margin."""
    k = int(n_candidates)
    comps: Dict[str, np.ndarray] = {}

    if rms_m is not None and sigma_m is not None and sigma_m > 0:
        r = np.asarray(rms_m, np.float64)
        comps["tdoa"] = -0.5 * max(n_pairs_active, 1) * (r / sigma_m) ** 2
    if power_scores is not None and n_stations >= 3:
        s = np.asarray(power_scores, np.float64)
        # SELF-CALIBRATING σ (round 5): the BEST candidate's score is
        # an estimate of the per-station log-amplitude mismatch floor
        # — antenna patterns plus CROSS-BAND calibration residue (the
        # REF-based gain calibration measures the front end at the REF
        # frequency; response differences at the TGT frequency do not
        # cancel). When it exceeds the calibrated σ_p, the 1/r model
        # fits NO candidate, and holding σ_p frozen makes the lane
        # wildly overconfident in what is then mostly calibration
        # noise — measured: a ±6 dB cross-band gain spread produced a
        # WRONG swap at frozen σ_p (BENCHLOG round 5, ghost-fdoa
        # regime). Flooring σ at min(s) collapses the lane's margins
        # exactly when its model is violated (the FDOA/prior lanes
        # then decide), and leaves clean scenes essentially unchanged
        # (their true-candidate scores sit at or below σ_p).
        sigma_eff = max(power_log_sigma, float(np.min(s)))
        llp = -0.5 * n_stations * (s / sigma_eff) ** 2
        if sigma_eff > power_log_sigma:
            # Model violated: the lane may LEAN but must not clear the
            # decision threshold alone. A corrupted calibration can be
            # anti-informative, not just uninformative — measured: one
            # ±6 dB gain draw made the GHOST fit 1/r better than the
            # truth (scores 0.16 vs 0.38) and power alone swapped onto
            # it. Capping the lane's relative log-odds at 2.0 nats
            # (below the 2.5 decision threshold) turns that into an
            # abstention unless an uncorrupted lane corroborates.
            llp = np.maximum(llp - llp.max(), -2.0)
        comps["power"] = llp
    if fdoa_resid_hz is not None or speeds_mps is not None:
        ll = np.zeros(k)
        if fdoa_resid_hz is not None and fdoa_dof > 0:
            r = np.asarray(fdoa_resid_hz, np.float64)
            ll = ll - 0.5 * fdoa_dof * (r / fdoa_sigma_hz) ** 2
        if speeds_mps is not None and max_speed_mps:
            v = np.asarray(speeds_mps, np.float64)
            over = np.maximum(v - max_speed_mps, 0.0)
            ll = ll - 0.5 * (over / (0.2 * max_speed_mps)) ** 2
        comps["fdoa"] = ll
    if prior_dist_m is not None and prior_radius_m:
        d = np.asarray(prior_dist_m, np.float64)
        out = np.maximum(d - prior_radius_m, 0.0)
        comps["prior"] = -0.5 * (out / (0.15 * prior_radius_m)) ** 2

    total = np.zeros(k)
    for ll in comps.values():
        total = total + np.where(np.isfinite(ll), ll, -1e9)
    log_odds = total - total.max()
    best = int(np.argmax(log_odds))
    if k > 1:
        margin = float(-np.partition(np.delete(log_odds, best), -1)[-1])
    else:
        margin = 0.0
    return GhostVerdict(
        log_odds=log_odds,
        best=best,
        margin_nats=margin,
        decided=bool(comps) and margin >= threshold_nats,
        threshold_nats=threshold_nats,
        components=comps,
    )
