"""Ghost-posterior calibration and validation harness of the PyTorch port.

``scripts/ghost_calibration.py`` on ``tdoa_tpu_torch``: the same three
subcommands, arguments, printed lines, exit code and artifact schema,
with the trials run by ``scripts/monte_carlo_torch.py`` (the port's
simulator and processor, on the card unless ``--device cpu``) and the
replay by ``tdoa_tpu_torch.solve.ghost``.

Phase 1 (gather): runs Monte Carlo trials over the ghost-prone
3-station regimes and records every ghost-ambiguous fix — per-candidate
truth errors, power scores, FDOA residuals/speeds, and the posterior
verdict the processor actually produced — to a JSON artifact.

Phase 2 (analyze, on the artifact): replays the posterior offline over
a grid of (POWER_LOG_SIGMA, threshold) and reports, per point:

    resolved-correct / resolved-WRONG / abstained-correct(leader true)
    / abstained(leader wrong)

The calibration rule: choose the smallest σ_p and threshold with ZERO
resolved-wrong across the calibration base, maximizing resolved-correct
— then validate frozen constants on fresh seed bases (the done
criterion: ≥ 9/10 resolved-or-correctly-abstained, zero wrong swaps, on
TWO fresh bases).

Usage:
  gather:  python scripts/ghost_calibration_torch.py gather --seed 120000 \
               --trials 40 --out calib_data/torch/GHOSTCAL_torch_120000.json
               [--device cpu]
  analyze: python scripts/ghost_calibration_torch.py analyze ART.json ... \
               [--sigma-grid 0.15,0.2,0.35] [--thresh-grid 1.5,2.5,4]
  validate: python scripts/ghost_calibration_torch.py validate ART.json
               (frozen constants, prints the criterion line; exit 1 when
               it is missed)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np  # noqa: E402

from tdoa_tpu_torch.solve.ghost import (  # noqa: E402
    DECISION_THRESHOLD_NATS,
    POWER_LOG_SIGMA,
    ghost_posterior,
)

# Ghost-prone regimes: 3-station geometries where an outside-the-hull
# emitter yields two timing-exact intersections. (Multipath/interferer
# ambiguity is a different mechanism with its own warnings; movers
# exercise the FDOA signal.)
REGIMES = ("clean", "noisy", "wild-clocks", "moving")


def gather(args) -> None:
    import monte_carlo_torch as mc
    from tdoa_tpu_torch.geo import lla_to_enu

    regimes = tuple(args.regimes.split(","))
    records = []
    n_trials = 0
    for regime in regimes:
        for t in range(args.trials):
            seed = (args.seed + 100 * t
                    + zlib.crc32(regime.encode()) % 97)
            r = mc.run_trial(regime, seed, args.device)
            n_trials += 1
            res = r.get("_res")
            if res is None or res.ghost is None:
                continue
            tgt = r["_tgt"]
            mid = r["_mid_off"]
            cand_errs = [
                float(np.linalg.norm(lla_to_enu(
                    np.array([c[0], c[1], tgt[2]]), tgt)[:2] - mid))
                for c in res.fix.candidates_lla
            ]
            g = res.ghost
            rec = {
                "regime": regime,
                "seed": seed,
                "cand_err_m": cand_errs,
                "cand_rms_m": [float(v) for v in res.fix.candidates_rms],
                "power_scores": (
                    None if res.fix.candidates_power_score is None
                    else [float(v)
                          for v in res.fix.candidates_power_score]
                ),
                "n_stations": len(res.station_names),
                "n_pairs_active": int(np.count_nonzero(
                    np.asarray(res.solve_weights) > 0)),
                "sigma_m": float(np.median(
                    np.asarray(res.tdoa_std_s)) * 299792458.0),
                "verdict": g.to_json(),
            }
            # FDOA evidence (already permuted to the reported order by
            # the processor, same as every other array here).
            rec["has_fdoa"] = "fdoa" in g.components
            records.append(rec)
            print(f"  ghost: {regime} seed {seed} "
                  f"cand_err {['%.0f' % e for e in cand_errs]} "
                  f"margin {g.margin_nats:.2f} decided {g.decided}",
                  flush=True)
    out = {
        "seed_base": args.seed,
        "trials_per_regime": args.trials,
        "regimes": list(regimes),
        "n_trials": n_trials,
        "n_ghosts": len(records),
        "records": records,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"{len(records)} ghost-ambiguous fixes in {n_trials} trials "
          f"-> {args.out}")


def replay(rec: dict, sigma_p: float, thresh: float,
           skip_fdoa: bool = False):
    """Recompute the power+tdoa posterior from the recorded evidence.
    FDOA components are kept as the processor computed them (they do
    not depend on σ_p). ``skip_fdoa`` drops the FDOA lane — the
    counterfactual that identifies FDOA-decided records."""
    k = len(rec["cand_err_m"])
    v = ghost_posterior(
        k,
        rms_m=np.asarray(rec["cand_rms_m"]),
        sigma_m=rec["sigma_m"],
        n_pairs_active=rec["n_pairs_active"],
        power_scores=(None if rec["power_scores"] is None
                      else np.asarray(rec["power_scores"])),
        n_stations=rec["n_stations"],
        threshold_nats=thresh,
        power_log_sigma=sigma_p,
    )
    total = v.log_odds.copy()
    comp = rec["verdict"]["components"]
    if "fdoa" in comp and not skip_fdoa:
        total = total + np.asarray(comp["fdoa"])
    if "prior" in comp:
        total = total + np.asarray(comp["prior"])
    total -= total.max()
    best = int(np.argmax(total))
    margin = (float(-np.partition(np.delete(total, best), -1)[-1])
              if k > 1 else 0.0)
    return best, margin, margin >= thresh


def _truth_ok(errs, true_k, rec) -> bool:
    """The decided candidate counts correct when it is near the truth
    in absolute terms, OR (far-field geometries, where along-range
    GDOP inflates every candidate's absolute error) when it is clearly
    SEPARATED from the alternatives: at most half as far from the
    truth as the worst candidate, so the decision picked the right
    intersection even if the range axis is soft."""
    abs_ok = errs[true_k] < max(300.0, 3.0 * rec["sigma_m"])
    sep_ok = (len(errs) > 1
              and errs[true_k] <= 0.5 * float(np.max(errs)))
    return abs_ok or sep_ok


def score(recs, sigma_p, thresh):
    """(resolved-correct, resolved-wrong, abstained with the true
    leader, abstained with a ghost leader) over ``recs``."""
    ok_res = wrong = ok_abst = bad_abst = 0
    for rec in recs:
        errs = np.asarray(rec["cand_err_m"])
        true_k = int(np.argmin(errs))
        best, margin, decided = replay(rec, sigma_p, thresh)
        # "correct" = the decided candidate is the closest-to-truth
        # one AND actually near the truth (a decided swap onto a bad
        # candidate set still counts wrong).
        if decided:
            if best == true_k and _truth_ok(errs, true_k, rec):
                ok_res += 1
            else:
                wrong += 1
        else:
            if best == true_k:
                ok_abst += 1
            else:
                bad_abst += 1
    return ok_res, wrong, ok_abst, bad_abst


def fdoa_decided(recs, sigma_p, thresh):
    """Two FDOA-lane exercise counts over the records:

    - fdoa_decisive: the full posterior decided CORRECTLY and the
      FDOA component ALONE clears the decision threshold for that
      same (correct) candidate — drop every other lane and the
      decision stands. The lane is independently decisive.
    - fdoa_counterfactual: decided correctly AND the FDOA-less replay
      could not decide (or led wrong) — decisions ONLY fdoa delivers
      (a strict subset: power often agrees on far ghosts).
    """
    n_dec = n_cf = 0
    for rec in recs:
        errs = np.asarray(rec["cand_err_m"])
        true_k = int(np.argmin(errs))
        best, _, decided = replay(rec, sigma_p, thresh)
        if not (decided and best == true_k
                and _truth_ok(errs, true_k, rec)):
            continue
        comp = rec["verdict"]["components"]
        if "fdoa" in comp:
            fd = np.asarray(comp["fdoa"], np.float64)
            fdn = fd - fd.max()
            bf = int(np.argmax(fdn))
            if len(fdn) > 1:
                mf = float(-np.partition(np.delete(fdn, bf), -1)[-1])
            else:
                mf = 0.0
            if bf == true_k and mf >= thresh:
                n_dec += 1
        b2, _, d2 = replay(rec, sigma_p, thresh, skip_fdoa=True)
        if not d2 or b2 != true_k:
            n_cf += 1
    return n_dec, n_cf


def analyze(args) -> None:
    recs = []
    for path in args.artifacts:
        with open(path) as f:
            recs.extend(json.load(f)["records"])
    print(f"{len(recs)} ghost records")
    sig_grid = [float(s) for s in args.sigma_grid.split(",")]
    th_grid = [float(s) for s in args.thresh_grid.split(",")]
    print(f"{'σ_p':>6} {'thr':>5} {'resolved-ok':>12} {'WRONG':>6} "
          f"{'abstain(ok-lead)':>17} {'abstain(bad-lead)':>18}")
    for sp in sig_grid:
        for th in th_grid:
            a, wr, c, d = score(recs, sp, th)
            print(f"{sp:6.2f} {th:5.1f} {a:12d} {wr:6d} {c:17d} {d:18d}")


def validate(args) -> int:
    """The frozen constants on one artifact: prints the criterion line;
    0 when it is met (no wrong swap, ≥ 9/10 resolved-or-correctly-
    abstained), else 1."""
    with open(args.artifacts[0]) as f:
        data = json.load(f)
    recs = data["records"]
    a, wr, c, d = score(recs, POWER_LOG_SIGMA, DECISION_THRESHOLD_NATS)
    n = len(recs)
    ok = a + c  # resolved-correct or correctly-abstained (leader true);
    # an abstention with a wrong leader still carries the warning and
    # the candidate list — count it separately but it is not a silent
    # wrong swap.
    fd, fcf = fdoa_decided(recs, POWER_LOG_SIGMA, DECISION_THRESHOLD_NATS)
    print(f"seed base {data['seed_base']}: {n} ghosts — "
          f"resolved-correct {a}, WRONG SWAPS {wr}, "
          f"abstained(true leader) {c}, abstained(ghost leader) {d}; "
          f"resolved-or-correctly-abstained {ok}/{n}; "
          f"FDOA-decisive (lane alone decides) {fd}; "
          f"FDOA-only (counterfactual) {fcf}")
    return 0 if wr == 0 and (n == 0 or ok * 10 >= n * 9) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gather")
    g.add_argument("--seed", type=int, default=42000)
    g.add_argument("--trials", type=int, default=40)
    g.add_argument("--out", default="GHOSTCAL.json")
    g.add_argument("--regimes", default=",".join(REGIMES),
                   help="comma list; e.g. ghost-fdoa for the far-field "
                        "power-blind regime")
    g.add_argument("--device", default=None,
                   help="'cpu' for the kernels' plain versions (default: "
                        "the card)")
    a = sub.add_parser("analyze")
    a.add_argument("artifacts", nargs="+")
    a.add_argument("--sigma-grid", default="0.15,0.2,0.25,0.35,0.5")
    a.add_argument("--thresh-grid", default="1.5,2.0,2.5,3.5,5.0")
    v = sub.add_parser("validate")
    v.add_argument("artifacts", nargs=1)
    args = ap.parse_args(argv)
    if args.cmd == "gather":
        gather(args)
    elif args.cmd == "analyze":
        analyze(args)
    else:
        return validate(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
