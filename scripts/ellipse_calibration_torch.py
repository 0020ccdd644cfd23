"""Error-ellipse calibration study of the PyTorch port: is the reported
1σ honest?

``scripts/ellipse_calibration.py``'s gate on ``tdoa_tpu_torch``. Every
fix carries a covariance propagated from the per-pair σ; over the
randomized scenes of ``scripts/monte_carlo_torch.py``, the normalized
position error maha = sqrt(eᵀ C⁻¹ e) should follow a chi(2-dof)
distribution: 39.3% of trials within 1σ, 86.5% within 2σ, 98.9% within
3σ. Under-coverage is false confidence, the one failure mode the system
forbids.

The regimes with a modeled error budget (clean, noisy, wild-clocks) are
gated: the script exits nonzero if their pooled 3σ coverage drops below
90%. Multipath is reported, not gated (an echo inside the correlation
peak biases the TDOA, which no noise covariance covers; the processor
flags those scenes instead). Ghost-flagged trials are left out: their
error is bimodal and their warning is their defense. Runs on the card
unless ``--device cpu``.

Usage: python scripts/ellipse_calibration_torch.py [--trials N] [--seed S]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np  # noqa: E402

import monte_carlo_torch as mc  # noqa: E402  (same directory)

CHI2_COVERAGE = {1.0: 0.393, 2.0: 0.865, 3.0: 0.989}
GATED = ("clean", "noisy", "wild-clocks")
REPORTED = GATED + ("multipath",)
GATE_3SIGMA = 0.90


def coverage_line(regime: str, ms: np.ndarray) -> str:
    """A regime's coverage within 1/2/3σ against chi(2), and maha's
    p50/p95."""
    if len(ms) == 0:
        return f"{regime:12s} n=  0"
    cov = {k: float((ms <= k).mean()) for k in CHI2_COVERAGE}
    return (f"{regime:12s} n={len(ms):3d}  "
            + "  ".join(f"{k:.0f}σ {cov[k]*100:5.1f}% (chi2 {v*100:.1f}%)"
                        for k, v in CHI2_COVERAGE.items())
            + f"  maha p50/p95 {np.percentile(ms, 50):.2f}/"
            f"{np.percentile(ms, 95):.2f}")


def regime_mahas(regime: str, trials: int, seed: int, device) -> tuple:
    """(maha of every trial with a covariance, ghost-flagged trials left
    out) over ``trials`` trials of ``regime``."""
    ms, n_ghost = [], 0
    for t in range(trials):
        r = mc.run_trial(regime, mc.trial_seed(regime, seed, t), device)
        if r["ambiguous"]:
            # Ghost-flagged: bimodal error, covered by the warning (and
            # the candidate list), not by the ellipse.
            n_ghost += 1
            continue
        if r["maha"] is not None:
            ms.append(r["maha"])
    return np.asarray(ms), n_ghost


def pooled_gate(pooled: dict, n_ghost: int) -> bool:
    """Print the pooled 3σ coverage of the gated regimes; True when it
    meets the gate."""
    gated = np.concatenate([pooled[r] for r in GATED])
    c3 = float((gated <= 3.0).mean()) if len(gated) else 0.0
    print(f"\npooled modeled-noise regimes ({', '.join(GATED)}): "
          f"n={len(gated)}, 3σ coverage {c3*100:.1f}% "
          f"(gate: >= {GATE_3SIGMA:.0%}); {n_ghost} ghost-flagged trials "
          f"excluded", flush=True)
    return c3 >= GATE_3SIGMA


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=25,
                    help="trials per regime")
    ap.add_argument("--seed", type=int, default=5000)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions (default: "
                         "the card)")
    args = ap.parse_args(argv)
    device = mc._device(args.device)
    t0 = time.perf_counter()
    pooled: dict = {}
    n_ghost = 0
    for regime in REPORTED:
        pooled[regime], ghosts = regime_mahas(regime, args.trials, args.seed,
                                              device)
        n_ghost += ghosts
        print(coverage_line(regime, pooled[regime]), flush=True)
    ok = pooled_gate(pooled, n_ghost)
    print(f"ellipse_calibration_torch: {time.perf_counter() - t0:.1f} s on "
          f"{device}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
