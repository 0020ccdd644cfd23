"""Fix-level multipath covariance diagnostic / calibration scan of the
PyTorch port.

``scripts/multipath_fixcov_diag.py`` on ``tdoa_tpu_torch``: runs the
Monte Carlo multipath regime of ``scripts/monte_carlo_torch.py`` (on the
card unless ``--device cpu``), captures the inputs of every
``fix_covariance_enu_correlated`` call (by wrapping the function at its
definition site, ``tdoa_tpu_torch.solve.multilateration``) plus the
trial's true fix-error vector, and reports, per candidate station-bias
inflation γ:

    maha(γ) = sqrt(eᵀ C(γ)⁻¹ e),  C(γ) = sandwich with τ → γ·τ

coverage at 1/2/3σ — so the fix-level calibration constant can be
chosen from measured evidence WITHOUT rerunning the trials per γ.
Trials where the correlated path never fired (no pair crossed the
centroid-offset knee, so the independent model was reported) are listed
separately: those coverage misses no τ scaling can touch.

Usage: python scripts/multipath_fixcov_diag_torch.py [--trials N]
       [--seed S] [--gammas 1.0,1.5,2.0] [--regime multipath]
       [--save out.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np  # noqa: E402

from tdoa_tpu_torch.solve import multilateration as ml  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=25)
    ap.add_argument("--seed", type=int, default=9000)
    ap.add_argument("--gammas", default="1.0,1.25,1.5,1.75,2.0,2.5,3.0")
    ap.add_argument("--regime", default="multipath")
    ap.add_argument("--save", default=None,
                    help="save captured trial inputs to this .npz for "
                         "offline γ exploration")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions (default: "
                         "the card)")
    args = ap.parse_args(argv)
    gammas = [float(g) for g in args.gammas.split(",")]

    captured: list = []
    orig = ml.fix_covariance_enu_correlated

    def spy(stations_enu, pair_idx, pos_enu, sigma_noise_m,
            station_bias_m, weights=None):
        captured.append(dict(
            stations_enu=np.array(stations_enu),
            pair_idx=np.array(pair_idx),
            pos_enu=np.array(pos_enu),
            sigma_noise_m=np.array(sigma_noise_m),
            station_bias_m=np.array(station_bias_m),
            weights=None if weights is None else np.array(weights),
        ))
        return orig(stations_enu, pair_idx, pos_enu, sigma_noise_m,
                    station_bias_m, weights)

    ml.fix_covariance_enu_correlated = spy
    try:
        import monte_carlo_torch as mc

        rows = []
        inactive = []  # (seed, maha) where the correlated path never fired
        for t in range(args.trials):
            captured.clear()
            seed = (args.seed + 100 * t
                    + zlib.crc32(args.regime.encode()) % 97)
            r = mc.run_trial(args.regime, seed, args.device)
            if (r["ambiguous"] or r["maha"] is None
                    or r.get("err_en") is None):
                continue
            if not captured:
                inactive.append((seed, r["maha"]))
                continue
            # The last call is the REPORTED fix's covariance (the one the
            # processor installs after _analyze_fix).
            rows.append((seed, np.asarray(r["err_en"]), captured[-1]))
    finally:
        ml.fix_covariance_enu_correlated = orig

    print(f"{len(rows)} correlated-path trials, "
          f"{len(inactive)} independent-model trials")
    if inactive:
        print("  independent-model trials (seed, maha): "
              + ", ".join(f"({s}, {m:.2f})" for s, m in inactive))
        ina = np.array([m for _, m in inactive])
        print(f"  their coverage: 1σ {np.mean(ina <= 1)*100:.0f}% "
              f"2σ {np.mean(ina <= 2)*100:.0f}% "
              f"3σ {np.mean(ina <= 3)*100:.0f}%")

    if args.save:
        blob = {}
        for i, (seed, e, c) in enumerate(rows):
            blob[f"t{i}_seed"] = np.array(seed)
            blob[f"t{i}_err"] = e
            for key, v in c.items():
                if v is not None:
                    blob[f"t{i}_{key}"] = v
        np.savez(args.save, n=np.array(len(rows)), **blob)
        print(f"saved {len(rows)} trials to {args.save}")

    print(f"\n{'γ':>5} {'1σ':>7} {'2σ':>7} {'3σ':>7} "
          f"{'p50':>6} {'p95':>6}   (chi2: 39.3 / 86.5 / 98.9%)")
    for g in gammas:
        ms = []
        for _, e, c in rows:
            cov = orig(c["stations_enu"], c["pair_idx"], c["pos_enu"],
                       c["sigma_noise_m"], g * c["station_bias_m"],
                       c["weights"])
            try:
                ms.append(float(np.sqrt(e @ np.linalg.solve(cov, e))))
            except np.linalg.LinAlgError:
                pass
        ms = np.asarray(ms)
        if len(ms) == 0:
            print(f"{g:5.2f}   no correlated-path trial")
            continue
        print(f"{g:5.2f} {np.mean(ms <= 1)*100:6.1f}% "
              f"{np.mean(ms <= 2)*100:6.1f}% {np.mean(ms <= 3)*100:6.1f}% "
              f"{np.percentile(ms, 50):6.2f} {np.percentile(ms, 95):6.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
