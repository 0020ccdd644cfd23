"""Multi-emitter TDOA association: candidate peaks → per-emitter sets.

When two co-channel emitters share the target frequency, each station
pair's correlation shows (up to) one peak per emitter. Taking only the
argmax (reference behavior, processor.go:646-736) mixes emitters across
pairs and produces either a wrong fix or — with the consistency gate —
a warning. This module *separates* them: extract the top-K correlation
peaks per pair, then associate one candidate per pair into internally
consistent sets using the TDOA cycle-consistency constraint

    tau_ij = tau_aj - tau_ai        (a = anchor station)

which holds per emitter (tau_ij = t_j - t_i is a function of per-station
arrival times). Hypotheses enumerate anchor-pair candidates (K^(n-1));
every cross pair must have a candidate within tolerance for the
hypothesis to survive. Greedy extraction removes used candidates and
repeats for the next emitter.

All of this runs host-side on tiny arrays ([pairs, K] candidates); the
expensive part — the correlation windows — already exists on device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np


class PeakCandidates(NamedTuple):
    lag: np.ndarray  # [m, k] sub-sample lag positions (window units)
    value: np.ndarray  # [m, k] peak heights (0 where no peak)


def main_lobe_width(window: np.ndarray) -> np.ndarray:
    """Half-max full width of each row's dominant peak, in samples.

    This is the correlation peak width (~sample_rate / signal
    bandwidth) — the natural exclusion scale below which "peaks" are
    main-lobe structure, not separate emitters.
    """
    w = np.asarray(window, np.float64)
    m, n = w.shape
    idx = np.argmax(w, axis=-1)
    half = 0.5 * w[np.arange(m), idx]
    widths = np.empty(m)
    for i in range(m):
        lo = hi = idx[i]
        while lo > 0 and w[i, lo - 1] >= half[i]:
            lo -= 1
        while hi < n - 1 and w[i, hi + 1] >= half[i]:
            hi += 1
        widths[i] = hi - lo + 1
    return widths


def top_k_peaks(
    window: np.ndarray, k: int, guard: Optional[int] = None
) -> PeakCandidates:
    """Top-k local peaks per row of ``window`` [m, W], strongest first.

    Iterative argmax with a ±guard exclusion zone, each refined by the
    three-point parabolic fit. Rows with fewer than k real peaks pad
    with value 0.

    ``guard=None`` (default) sizes the exclusion zone from the measured
    main-lobe width (median over rows, floor 8): shoulders of a wide
    correlation peak must not become candidates, or a single narrowband
    emitter assembles a cycle-consistent phantom second emitter from
    its own main-lobe structure.
    """
    if guard is None:
        guard = max(8, int(np.ceil(np.median(main_lobe_width(window)))))
    w = np.array(window, np.float64, copy=True)
    m, n = w.shape
    lags = np.zeros((m, k))
    vals = np.zeros((m, k))
    for kk in range(k):
        idx = np.argmax(w, axis=-1)
        val = w[np.arange(m), idx]
        ic = np.clip(idx, 1, n - 2)
        ym1 = window[np.arange(m), ic - 1]
        y0 = window[np.arange(m), ic]
        yp1 = window[np.arange(m), ic + 1]
        denom = ym1 - 2.0 * y0 + yp1
        safe = np.where(np.abs(denom) > 1e-12, denom, 1.0)
        off = np.where(np.abs(denom) > 1e-12, 0.5 * (ym1 - yp1) / safe, 0.0)
        off = np.clip(off, -0.5, 0.5)
        interior = (idx >= 1) & (idx <= n - 2)
        lags[:, kk] = idx + np.where(interior, off, 0.0)
        vals[:, kk] = np.where(val > 0, val, 0.0)
        for row, i in zip(w, idx.tolist()):  # the ±guard exclusion zone
            row[max(i - guard, 0):i + guard + 1] = -np.inf
    return PeakCandidates(lag=lags, value=vals)


class EmitterSet(NamedTuple):
    tdoa: np.ndarray  # [m] one associated TDOA per pair (samples)
    value: np.ndarray  # [m] peak height of the chosen candidate
    candidate_idx: np.ndarray  # [m] which of the k candidates was used
    score: float  # sum of chosen peak heights
    max_inconsistency: float  # worst |cand - predicted| over cross pairs


def associate_emitters(
    cand_tdoa: np.ndarray,  # [m, k] candidate TDOAs (clock-corrected, samples)
    cand_value: np.ndarray,  # [m, k] peak heights (0 = no candidate)
    pair_idx: np.ndarray,  # [m, 2] station index pairs
    n_stations: int,
    tol_samples: float = 3.0,
    max_emitters: int = 2,
    min_value_frac: float = 0.15,
) -> List[EmitterSet]:
    """Greedy cycle-consistent association of per-pair candidates.

    Returns up to ``max_emitters`` internally consistent TDOA sets,
    strongest first. Candidates weaker than ``min_value_frac`` of their
    pair's strongest peak never anchor a hypothesis (noise floor), but
    can still complete one as cross-pair matches.
    """
    joint = associate_emitters_joint(
        cand_tdoa,
        np.zeros_like(cand_tdoa),  # no Doppler axis: zeros + inf tol
        cand_value,
        pair_idx,
        n_stations,
        tol_samples=tol_samples,
        tol_hz=np.inf,
        max_emitters=max_emitters,
        min_value_frac=min_value_frac,
    )
    return [es for es, _ in joint]


# Resolution limit: two emitters whose TDOAs on a pair differ by less
# than the correlation peak width (~ sample_rate / signal bandwidth;
# ~40 samples for a 50 kHz FM signal at 2 Msps) merge into one peak on
# that pair and cannot be separated in the lag domain — the association
# then finds only the stronger emitter. Separating them needs a
# different discriminant (Doppler via ops/caf.py, or modulation-domain
# correlation via mode="fm").


def top_k_peaks_2d(
    surface: np.ndarray,  # [m, D, W] |CAF| per pair
    k: int,
    guard_lag: Optional[int] = None,
    guard_dop: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-k joint (Doppler, lag) peaks per pair on a CAF surface.

    Returns (lag_pos [m,k], dop_pos [m,k], value [m,k]); positions are
    sub-bin parabolic along each axis. The exclusion zone is a
    (±guard_dop, ±guard_lag) rectangle; guard_lag=None auto-sizes from
    the dominant peak's main-lobe width like top_k_peaks.
    """
    m, nd, nw = surface.shape
    if guard_lag is None:
        guard_lag = caf_lag_resolution(surface)
    w = np.array(surface, np.float64, copy=True)
    lags = np.zeros((m, k))
    dops = np.zeros((m, k))
    vals = np.zeros((m, k))

    def para(y, i):
        if 0 < i < len(y) - 1:
            den = y[i - 1] - 2 * y[i] + y[i + 1]
            if abs(den) > 1e-12:
                return float(np.clip(0.5 * (y[i - 1] - y[i + 1]) / den,
                                     -0.5, 0.5))
        return 0.0

    for pk in range(m):
        for kk in range(k):
            flat = int(np.argmax(w[pk]))
            di, wi = divmod(flat, nw)
            v = w[pk, di, wi]
            if not np.isfinite(v) or v <= 0:
                break
            lags[pk, kk] = wi + para(surface[pk, di, :], wi)
            dops[pk, kk] = di + para(surface[pk, :, wi], di)
            vals[pk, kk] = v
            w[pk,
              max(0, di - guard_dop):di + guard_dop + 1,
              max(0, wi - guard_lag):wi + guard_lag + 1] = -np.inf
    return lags, dops, vals


def caf_lag_resolution(surface: np.ndarray) -> int:
    """Lag resolution scale of a CAF surface: the dominant peak's
    main-lobe width (median over pairs, floor 8) — also the right
    exclusion radius and lag-consistency tolerance for joint
    association (the CAF's envelope peak is only localized to a
    fraction of this width; Doppler carries the fine discrimination)."""
    m = surface.shape[0]
    best_d = np.argmax(surface.max(axis=2), axis=1)
    rows = surface[np.arange(m), best_d]  # [m, W]
    return max(8, int(np.ceil(np.median(main_lobe_width(rows)))))


def associate_emitters_joint(
    cand_tdoa: np.ndarray,  # [m, k] clock-corrected TDOAs, samples
    cand_fdoa: np.ndarray,  # [m, k] drift-corrected Dopplers, Hz
    cand_value: np.ndarray,  # [m, k] peak heights (0 = no candidate)
    pair_idx: np.ndarray,
    n_stations: int,
    tol_samples: float = 3.0,
    tol_hz: float = 8.0,
    max_emitters: int = 2,
    min_value_frac: float = 0.15,
) -> List[Tuple[EmitterSet, np.ndarray]]:
    """Cycle-consistent association in BOTH lag and Doppler.

    tau_ij = tau_aj − tau_ai AND nu_ij = nu_aj − nu_ai hold per emitter
    (both are differences of per-station quantities), so a hypothesis
    must be consistent on both axes — which separates two emitters even
    when their TDOAs collide on some pair, and attributes each emitter
    its own FDOA set. Returns [(EmitterSet, fdoa [m])].
    """
    m, k = cand_tdoa.shape
    pair_of = {tuple(p): i for i, p in enumerate(map(tuple, pair_idx))}
    anchor_pairs = [pair_of[(0, j)] for j in range(1, n_stations)]
    cross_pairs = [
        (pair_of[(i, j)], i, j)
        for i in range(1, n_stations)
        for j in range(i + 1, n_stations)
    ]
    avail = cand_value > 0
    floor = min_value_frac * cand_value.max(axis=1, keepdims=True)
    results: List[Tuple[EmitterSet, np.ndarray]] = []
    k_eff = k
    while k_eff > 1 and k_eff ** len(anchor_pairs) > 20_000:
        k_eff -= 1

    for _ in range(max_emitters):
        best = None
        for combo in np.ndindex(*([k_eff] * len(anchor_pairs))):
            ok = True
            tau0 = np.zeros(n_stations)
            nu0 = np.zeros(n_stations)
            chosen = np.full(m, -1, int)
            for ap, c in zip(anchor_pairs, combo):
                if not avail[ap, c] or cand_value[ap, c] < floor[ap, 0]:
                    ok = False
                    break
                j = pair_idx[ap, 1]
                tau0[j] = cand_tdoa[ap, c]
                nu0[j] = cand_fdoa[ap, c]
                chosen[ap] = c
            if not ok:
                continue
            worst = 0.0
            for cp, i, j in cross_pairs:
                pred_t = tau0[j] - tau0[i]
                pred_f = nu0[j] - nu0[i]
                # Normalized joint distance; both axes must agree.
                dist = np.maximum(
                    np.abs(cand_tdoa[cp] - pred_t) / tol_samples,
                    np.abs(cand_fdoa[cp] - pred_f) / tol_hz,
                )
                dist = np.where(avail[cp], dist, np.inf)
                c = int(np.argmin(dist))
                if dist[c] > 1.0:
                    ok = False
                    break
                chosen[cp] = c
                # Report the LAG residual in actual samples (the joint
                # gate may have been dominated by the Doppler axis).
                worst = max(worst, float(np.abs(cand_tdoa[cp, c] - pred_t)))
            if not ok:
                continue
            vals = cand_value[np.arange(m), chosen]
            cand_set = EmitterSet(
                tdoa=cand_tdoa[np.arange(m), chosen],
                value=vals,
                candidate_idx=chosen,
                score=float(vals.sum()),
                max_inconsistency=worst,
            )
            if best is None or cand_set.score > best[0].score:
                best = (cand_set, cand_fdoa[np.arange(m), chosen])
        if best is None:
            break
        results.append(best)
        avail[np.arange(m), best[0].candidate_idx] = False
    return results
