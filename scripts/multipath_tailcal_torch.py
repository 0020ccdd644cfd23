"""Heavy-tailed multipath fix-coverage calibration of the PyTorch port.

``scripts/multipath_tailcal.py`` on ``tdoa_tpu_torch``: the same two
subcommands, command line, ``.npz`` fields and artifact JSON, with the
trials run by ``scripts/monte_carlo_torch.py`` (the port's simulator
and processor, on the card unless ``--device cpu``) and the replayed
covariance the port's ``solve.multilateration.
fix_covariance_enu_correlated``. Either script's ``fit`` reads either
package's bases.

The model it fits: ONE γ (the per-pair-calibrated 2.0) for every
echo-ENGAGED fix, plus a Student-t radial tail — maha²/2 ~ F(2, ν)
fitted by maximum likelihood on the pooled engaged-row maha samples,
giving per-level CONTOUR scale factors s_k = q_t(p_k)/k (p_k the χ(2)
mass at kσ). The processor reports cov_en at γ and ``conf_scales`` =
(s_1, s_2, s_3) (``dsp.multipath.ECHO_TAIL_CONF_SCALES``); the kσ
confidence contour is the k·s_k ellipse.

capture  — run the Monte Carlo multipath regime for one base seed,
           spying the reported fix's covariance inputs with the RAW
           per-station τ (the in-effect γ divided out via a
           station_bias_apportion spy) + the echo-environment
           confirmation flag + the true error vector; saves one .npz
           per base. Trial behavior is UNCHANGED (the shipped
           constants stay in effect during capture).

fit      — pool the capture bases, fit (γ_core, ν), report per-base
           coverage at the calibrated thresholds T_k = k·s_k with
           holdout validation, and emit the artifact JSON.

Usage:
  python scripts/multipath_tailcal_torch.py capture --seed 150000 \
      --trials 25 --out calib_data/torch/mp_base_torch_150000.npz \
      [--device cpu]
  python scripts/multipath_tailcal_torch.py fit \
      --bases calib_data/torch/mp_base_torch_1[56]*.npz \
      --holdout calib_data/torch/mp_base_torch_165000.npz \
      --json calib_data/torch/MULTIPATH_CAL_torch.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np  # noqa: E402

# χ(2) radial masses at the 1σ/2σ/3σ contours — the nominal coverage
# the calibrated thresholds must reproduce.
CHI2_MASS = (0.3935, 0.8647, 0.9889)
CHI2_MEDIAN = 1.1774


def capture(args) -> None:
    from tdoa_tpu_torch.dsp import multipath as mp
    from tdoa_tpu_torch.solve import multilateration as ml

    cov_calls: list = []
    tau_calls: list = []
    orig_cov = ml.fix_covariance_enu_correlated
    orig_app = mp.station_bias_apportion

    def spy_cov(stations_enu, pair_idx, pos_enu, sigma_noise_m,
                station_bias_m, weights=None):
        cov_calls.append(dict(
            stations_enu=np.array(stations_enu),
            pair_idx=np.array(pair_idx),
            pos_enu=np.array(pos_enu),
            sigma_noise_m=np.array(sigma_noise_m),
            station_bias_m=np.array(station_bias_m),
            weights=None if weights is None else np.array(weights),
        ))
        return orig_cov(stations_enu, pair_idx, pos_enu, sigma_noise_m,
                        station_bias_m, weights)

    def spy_app(pair_idx, n_st, pair_sigma):
        tau = orig_app(pair_idx, n_st, pair_sigma)
        tau_calls.append(np.array(tau))
        return tau

    # The processor imports both names from their modules at call time,
    # so replacing the module attributes reaches every trial.
    ml.fix_covariance_enu_correlated = spy_cov
    mp.station_bias_apportion = spy_app
    try:
        import monte_carlo_torch as mc

        rows = []
        independents = []  # trials where the correlated path never fired
        for t in range(args.trials):
            cov_calls.clear()
            tau_calls.clear()
            seed = (args.seed + 100 * t
                    + zlib.crc32(b"multipath") % 97)
            r = mc.run_trial("multipath", seed, args.device)
            if (r["ambiguous"] or r["maha"] is None
                    or r.get("err_en") is None):
                continue
            if not cov_calls or not tau_calls:
                # Invisible-echo trial: the detector never fired; the
                # reported covariance is the independent model. Record
                # its own maha so per-base coverage can include it.
                independents.append((seed, float(r["maha"])))
                continue
            c = cov_calls[-1]
            # station_bias_apportion returns τ in SAMPLES; the processor
            # scales by γ · c/fs into meters before the covariance call.
            # Record raw τ in METERS so _maha's γ·τ replays are
            # unit-true.
            tau_raw = tau_calls[-1] * (299792458.0 / 2e6)
            # In-effect γ (2.0 unconfirmed / 5.0 confirmed): divide it
            # back out so the fit explores raw τ scalings.
            nz = tau_raw > 0
            gamma_eff = float(np.median(
                c["station_bias_m"][nz] / tau_raw[nz])) if nz.any() else 1.0
            confirmed = bool(gamma_eff > 3.0)
            rows.append(dict(
                seed=seed, err=np.asarray(r["err_en"], np.float64),
                tau_raw=tau_raw, gamma_eff=gamma_eff,
                confirmed=confirmed, **c,
            ))
            print(f"  trial {t}: seed {seed} confirmed={confirmed} "
                  f"maha={r['maha']:.2f} "
                  f"|err|={np.hypot(*r['err_en']):.1f} m", flush=True)
    finally:
        ml.fix_covariance_enu_correlated = orig_cov
        mp.station_bias_apportion = orig_app

    blob = {"n": np.array(len(rows)),
            "ind_seeds": np.array([s for s, _ in independents]),
            "ind_maha": np.array([m for _, m in independents])}
    for i, row in enumerate(rows):
        for key, v in row.items():
            if v is None:
                continue
            blob[f"t{i}_{key}"] = np.asarray(v)
    np.savez(args.out, **blob)
    print(f"saved {len(rows)} correlated + {len(independents)} "
          f"independent-model trials to {args.out}")


def _load_base(path):
    z = np.load(path, allow_pickle=False)
    n = int(z["n"])
    rows = []
    for i in range(n):
        rows.append({
            k[len(f"t{i}_"):]: z[k] for k in z.files
            if k.startswith(f"t{i}_")
        })
    ind = list(np.asarray(z["ind_maha"], np.float64))
    return rows, ind


def _maha(row, gamma: float) -> float:
    from tdoa_tpu_torch.solve import multilateration as ml

    w = row.get("weights")
    cov = ml.fix_covariance_enu_correlated(
        row["stations_enu"], row["pair_idx"], row["pos_enu"],
        row["sigma_noise_m"], gamma * row["tau_raw"],
        None if w is None or w.size == 0 else w,
    )
    e = row["err"]
    return float(np.sqrt(e @ np.linalg.solve(cov, e)))


def _fit_nu(ms: np.ndarray, nus=(2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 20.0,
                                 50.0)) -> float:
    """ML fit of the Student-t dof ν for 2-D radial maha samples:
    maha²/2 ~ F(2, ν). Returns the grid ν with the highest pooled
    log-likelihood (∞ ≈ 50 means the tail is effectively Gaussian)."""
    from scipy import stats

    best, best_ll = nus[-1], -np.inf
    x = ms * ms / 2.0
    for nu in nus:
        ll = float(np.sum(stats.f.logpdf(x, 2, nu) + np.log(ms)))
        if ll > best_ll:
            best, best_ll = nu, ll
    return best


def _t_radius(p: float, nu: float) -> float:
    """Radius T with P(maha ≤ T) = p under maha²/2 ~ F(2, ν)."""
    from scipy import stats

    return float(np.sqrt(2.0 * stats.f.ppf(p, 2, nu)))


def fit(args) -> dict:
    """Fit the bases, print the coverage table, write ``args.json`` if
    given; returns the report (the artifact's fields)."""
    bases = []
    for pat in args.bases:
        for p in sorted(glob.glob(pat)):
            bases.append((os.path.basename(p), *_load_base(p)))
    holdout = None
    if args.holdout:
        holdout = (os.path.basename(args.holdout),
                   *_load_base(args.holdout))

    # The model: ONE γ for every engaged row (the per-pair-calibrated
    # 2.0 — no separate confirmed tier) plus Student-t radial contour
    # scales applied whenever the echo-bias accounting engaged. γ is
    # swept here only to document that the choice is measured, not
    # assumed. Pool by UNIQUE trial seed: base seed ranges may overlap
    # (base + 100·t spans 2,400), so a naive pool would double-count
    # shared trials in the fit. Per-base coverage below is reported
    # as-is.
    seen = set()
    all_rows = []
    n_dup = 0
    for _, rows, _ in bases:
        for r in rows:
            s = int(r["seed"])
            if s in seen:
                n_dup += 1
                continue
            seen.add(s)
            all_rows.append(r)
    n_conf = sum(1 for r in all_rows if bool(r["confirmed"]))
    print(f"{n_conf} confirmed + {len(all_rows) - n_conf} unconfirmed "
          f"unique correlated rows across {len(bases)} bases "
          f"({n_dup} duplicate seeds dropped from the pooled fit)")
    gammas = np.arange(1.0, 4.01, 0.25)
    med = np.array([
        np.median([_maha(r, g) for r in all_rows]) for g in gammas
    ])
    for g, m in zip(gammas, med):
        print(f"  γ={g:4.2f}: pooled engaged-row median maha {m:.2f}")
    g_core = 2.0  # the per-pair-calibrated scale
    ms_core = np.array([_maha(r, g_core) for r in all_rows])
    print(f"γ = {g_core} (pooled median maha {np.median(ms_core):.2f}; "
          f"p95 {np.percentile(ms_core, 95):.2f})")

    # ---- tail: Student-t ν on the pooled engaged-row maha ----
    nu = _fit_nu(ms_core)
    thresholds = [_t_radius(p, nu) for p in CHI2_MASS]
    scales = [t / k for t, k in zip(thresholds, (1.0, 2.0, 3.0))]
    print(f"ν = {nu}; thresholds T1/T2/T3 = "
          + "/".join(f"{t:.2f}" for t in thresholds)
          + "  (contour scales " + "/".join(f"{s:.2f}" for s in scales)
          + ")")

    # ---- validation: per-base coverage at the calibrated thresholds.
    # Engaged rows: γ·τ + t thresholds. Independent-model rows (echo
    # accounting never engaged): their own maha + Gaussian thresholds.
    def base_cov(rows, ind):
        ms_t = np.array([_maha(r, g_core) for r in rows])
        ms_g = np.array(list(ind))
        n = len(ms_t) + len(ms_g)
        cov = []
        for k, t_k in zip((1.0, 2.0, 3.0), thresholds):
            hits = (np.sum(ms_t <= t_k)
                    + (np.sum(ms_g <= k) if len(ms_g) else 0))
            cov.append(100.0 * hits / max(n, 1))
        p50 = (float(np.median(ms_t)) if len(ms_t) else None)
        return cov, n, p50

    report = {"gamma": g_core, "nu": nu,
              "pooled_unique_rows": len(all_rows),
              "duplicate_seeds_dropped": n_dup,
              "seed_overlap_note": (
                  f"{n_dup} trial seeds shared between bases; the pooled "
                  "fit deduplicates, per-base rows are as-captured"
              ),
              "model": "single γ for every echo-engaged fix + "
                       "Student-t(ν) radial contour scales "
                       "(maha²/2 ~ F(2, ν)); no confirmed-γ tier",
              "thresholds": [round(t, 3) for t in thresholds],
              "contour_scales": [round(s, 3) for s in scales],
              "chi2_mass": list(CHI2_MASS),
              "pooled_engaged_p50_maha": round(
                  float(np.median(ms_core)), 3),
              "bases": {}}
    print(f"\n{'base':>22} {'n':>4} {'1σ':>7} {'2σ':>7} {'3σ':>7} "
          f"{'p50(engaged)':>13}")
    pooled = np.zeros(3)
    pooled_n = 0
    for name, rows, ind in bases + ([holdout] if holdout else []):
        cov, n, p50 = base_cov(rows, ind)
        tag = " (holdout)" if holdout and name == holdout[0] else ""
        print(f"{name + tag:>22} {n:>4} {cov[0]:6.1f}% {cov[1]:6.1f}% "
              f"{cov[2]:6.1f}% {p50 if p50 is None else round(p50, 2)!s:>10}")
        report["bases"][name] = {
            "n": n, "coverage_pct": [round(c, 1) for c in cov],
            "p50_engaged_maha": None if p50 is None else round(p50, 3),
            "holdout": bool(tag),
        }
        pooled += np.array(cov) * n
        pooled_n += n
    report["pooled_coverage_pct"] = [
        round(c, 1) for c in (pooled / max(pooled_n, 1))
    ]
    report["pooled_n"] = pooled_n
    print(f"{'POOLED':>22} {pooled_n:>4} "
          + " ".join(f"{c:6.1f}%" for c in pooled / max(pooled_n, 1)))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.json}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    cap = sub.add_parser("capture")
    cap.add_argument("--seed", type=int, required=True)
    cap.add_argument("--trials", type=int, default=25)
    cap.add_argument("--out", required=True)
    cap.add_argument("--device", default=None,
                     help="'cpu' for the kernels' plain versions (default: "
                          "the card)")
    fit_p = sub.add_parser("fit")
    fit_p.add_argument("--bases", nargs="+", required=True)
    fit_p.add_argument("--holdout", default=None)
    fit_p.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.cmd == "capture":
        capture(args)
    else:
        fit(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
