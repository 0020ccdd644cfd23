"""Weak-signal impairment simulator CLI on the PyTorch/CUDA port —
weak_signal_simulator.go contract: weak/noisy REF (Gaussian noise,
impulses, phase drift, DC offset) against a strong clean TGT; prints
predicted SNRs.

    python -m tdoa_tpu_torch.cli.weak_signal_simulator [common args]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from tdoa_tpu_torch.cli.simulator import (
    _add_common_args,
    build_scene,
    run_and_report,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="weak_signal_simulator",
        description="Realistic weak-REF impairment simulator",
    )
    _add_common_args(p)
    p.add_argument("--ref-snr-scale", type=float, default=1.0,
                   help="scale the weak-REF signal amplitude")
    p.add_argument("--multipath-amp", type=float, default=0.0,
                   help="specular echo amplitude relative to the direct "
                        "path (both signals)")
    p.add_argument("--multipath-delay", type=float, default=0.0,
                   help="nominal echo excess delay in samples "
                        "(jittered ±20%% per station)")
    args = p.parse_args(argv)
    if (args.multipath_amp > 0) != (args.multipath_delay > 0):
        p.error("--multipath-amp and --multipath-delay must be given together")

    from tdoa_tpu_torch.sim import STRONG_TGT_PROFILE, WEAK_REF_PROFILE

    mp = dict(
        multipath_amplitude=args.multipath_amp,
        multipath_delay_samples=args.multipath_delay,
    )
    ref_prof = dataclasses.replace(
        WEAK_REF_PROFILE,
        signal_amplitude=WEAK_REF_PROFILE.signal_amplitude * args.ref_snr_scale,
        **mp,
    )
    tgt_prof = dataclasses.replace(STRONG_TGT_PROFILE, **mp)
    scene = build_scene(args, ref_prof, tgt_prof)
    # Predicted per-sample SNRs (weak_signal_simulator.go:251-254 parity).
    ref_snr = 20 * np.log10(
        ref_prof.signal_amplitude / (np.sqrt(2) * ref_prof.noise_amplitude)
    )
    tgt_snr = 20 * np.log10(
        STRONG_TGT_PROFILE.signal_amplitude
        / (np.sqrt(2) * STRONG_TGT_PROFILE.noise_amplitude)
    )
    print(f"Predicted per-sample SNR: REF {ref_snr:.1f} dB (weak), "
          f"TGT {tgt_snr:.1f} dB (strong)")
    print(f"Impairments: {ref_prof.impulse_rate*100:.2f}% impulses, "
          f"{ref_prof.phase_drift_rad_s} rad/s drift, "
          f"DC {ref_prof.dc_offset}"
          + (f", echo {args.multipath_amp}x @ ~{args.multipath_delay} samp"
             if args.multipath_amp > 0 else ""))
    return run_and_report(scene, args.out, "weak-", device=args.device)


if __name__ == "__main__":
    sys.exit(main())
