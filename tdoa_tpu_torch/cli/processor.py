"""TDOA processor CLI on the PyTorch/CUDA port — the reference contract:

    python -m tdoa_tpu_torch.cli.processor <ref_freq> <target_freq> \
        <stations.csv> <dat1> <dat2> <dat3> [...]

Loads the captures onto the card (``--device cpu`` runs the kernels'
plain versions on the CPU instead), correlates raw IQ (the fused
kernels, or the segmented correlator for short blocks, lags beyond
20480 or ``--seg-len``) or FM-demodulated audio (``--mode fm``) with
dual-REF clock correction, prints per-pair TDOAs and the position fix.
``--lo-compensation`` derotates receiver LO offsets measured on the REF
block, ``--solve-velocity`` adds the CAF/FDOA emitter velocity and
``--multi-emitter N`` separates co-channel emitters.
``--overlap-ingest`` keeps the files on the host and streams them to the
device chunk by chunk (``TDOAProcessor.process_files_overlapped``).
Flags of ``tdoa_tpu.cli.processor`` whose paths are not ported yet are
accepted and rejected with a message naming the ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

from tdoa_tpu_torch.cli import parse_prior, rewrite_prior_argv

# Flags of the reference CLI this port does not run yet: their default
# (accepted) and the ROADMAP item that ports them.
_UNPORTED = {
    "geojson": (None, "host tools"),
    "profile": (False, "port benchmark"),
    "trace": (None, "port benchmark"),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="processor",
        description="Offline TDOA processing on the PyTorch/CUDA port: "
                    ".dat captures -> position fix",
    )
    p.add_argument("ref_freq", type=float, help="reference frequency, Hz")
    p.add_argument("target_freq", type=float, help="target frequency, Hz")
    p.add_argument("csv", help="lat-lon-table.csv station geometry")
    p.add_argument("dat_files", nargs="+", help=".dat capture files (>= 3)")
    p.add_argument("--max-lag", type=int, default=20000,
                   help="correlation search window, samples (default "
                        "20000; beyond 20480, the fused kernel's alias-free "
                        "window, the segmented correlator runs)")
    p.add_argument("--seg-len", type=int, default=1 << 16,
                   help="segment length of the segmented correlator, "
                        "samples (default 2^16)")
    p.add_argument("--weighting", default="ht",
                   choices=["ht", "ml", "phat", "scot", "none"])
    p.add_argument("--no-clock-correction", action="store_true",
                   help="skip dual-frequency reference clock removal")
    p.add_argument("--mode", default="iq", choices=["iq", "fm"],
                   help="correlate raw IQ or FM-demodulated audio")
    p.add_argument("--fm-decim", type=int, default=8,
                   help="audio decimation factor for --mode fm (divides 128)")
    p.add_argument("--lo-compensation", action="store_true",
                   help="probe the REF block for receiver LO offsets "
                        "(real TCXOs: ~16 Hz per 0.1 ppm at VHF smear "
                        "every correlation) and derotate all blocks "
                        "before processing")
    p.add_argument("--solve-velocity", action="store_true",
                   help="CAF over the TGT block + FDOA least squares: "
                        "emitter velocity at the fix (clock-drift "
                        "Doppler removed via the dual REF blocks)")
    p.add_argument("--prior", metavar="LAT,LON,RADIUS_KM", default=None,
                   help="coverage prior: center lat,lon (deg) and radius "
                        "(km); a unique in-prior candidate resolves a "
                        "ghost-ambiguous fix")
    p.add_argument("--power-disambiguation", action="store_true",
                   help="let a decisive 1/r received-power ranking move a "
                        "ghost-ambiguous fix")
    p.add_argument("--no-fdoa-disambiguation", action="store_true",
                   help="disable the FDOA ghost disambiguator "
                        "(--solve-velocity runs: the emitter velocity "
                        "is solved at every ghost candidate; decisive "
                        "fit-residual margin or speed plausibility "
                        "moves the fix to the physical candidate)")
    p.add_argument("--max-emitter-speed", type=float, default=700.0,
                   metavar="MPS",
                   help="speed plausibility ceiling (m/s) for the FDOA "
                        "ghost ranking only — never gates the velocity "
                        "solve itself (default 700)")
    p.add_argument("--no-outlier-rejection", action="store_true",
                   help="disable leave-one-station-out outlier rejection")
    p.add_argument("--multi-emitter", type=int, default=1, metavar="N",
                   help="separate up to N co-channel emitters by "
                        "correlation-peak cycle-consistency (default 1: off)")
    p.add_argument("--truncate-s", type=float, default=None,
                   help="use only the first N seconds of each block")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; an error when "
                        "none is visible — pass cpu to run on the CPU)")
    p.add_argument("--json", action="store_true",
                   help="emit one machine-readable JSON line")
    p.add_argument("--overlap-ingest", action="store_true",
                   help="stream the captures host->device chunk-by-chunk "
                        "with the file read, the copy and the correlation "
                        "overlapped; standard IQ pipeline only")
    # Reference flags whose paths are not ported yet.
    p.add_argument("--geojson", default=None)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--trace", default=None)
    args = p.parse_args(
        rewrite_prior_argv(sys.argv[1:] if argv is None else argv))
    for name, (default, item) in _UNPORTED.items():
        if getattr(args, name) != default:
            p.error(f"--{name.replace('_', '-')} is not ported to "
                    f"tdoa_tpu_torch yet (ROADMAP.md: \"{item}\"); "
                    f"use python -m tdoa_tpu.cli.processor")
    prior = None if args.prior is None else parse_prior(args.prior, p.error)

    from tdoa_tpu_torch.pipeline import TDOAProcessor
    from tdoa_tpu_torch.utils.constants import DEFAULT_SAMPLE_RATE

    trunc = (int(args.truncate_s * DEFAULT_SAMPLE_RATE)
             if args.truncate_s is not None else None)
    try:
        proc = TDOAProcessor.from_csv(
            args.ref_freq, args.target_freq, args.csv, device=args.device,
            max_lag=args.max_lag,
            seg_len=args.seg_len,
            weighting=args.weighting,
            clock_correction=not args.no_clock_correction,
            mode=args.mode,
            fm_decim=args.fm_decim,
            truncate_samples=trunc,
            multi_emitter=args.multi_emitter,
            solve_velocity=args.solve_velocity,
            lo_compensation="auto" if args.lo_compensation else "off",
            power_disambiguation=args.power_disambiguation,
            fdoa_disambiguation=not args.no_fdoa_disambiguation,
            max_emitter_speed_mps=args.max_emitter_speed,
            prior=prior,
            outlier_rejection=not args.no_outlier_rejection,
        )
    except RuntimeError as e:  # no card visible and no --device
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"Processing {len(args.dat_files)} captures on {proc.device} "
          f"(ref {args.ref_freq/1e6:.4f} MHz, target "
          f"{args.target_freq/1e6:.4f} MHz)",
          file=sys.stderr if args.json else sys.stdout)
    try:
        run = (proc.process_files_overlapped if args.overlap_ingest
               else proc.process_files)
        res = run(args.dat_files)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    names = res.station_names
    fix = res.fix
    if args.json:
        print(json.dumps({
            "fix": {"lat": fix.lat, "lon": fix.lon, "elev": fix.elev,
                    "rms_residual_m": fix.rms_residual_m,
                    "ellipse_1sigma_m": None if fix.ellipse is None else
                    {"semi_major": fix.ellipse[0],
                     "semi_minor": fix.ellipse[1],
                     "azimuth_deg": fix.ellipse[2]},
                    "conf_contour_scales": (
                        None if fix.conf_scales is None
                        else list(fix.conf_scales))},
            "tdoa_std_us": None if res.tdoa_std_s is None else
            [s * 1e6 for s in res.tdoa_std_s],
            "stations": names,
            "pairs": [[names[i], names[j]] for i, j in res.pair_idx],
            "tdoa_us": [s * 1e6 for s in res.tdoa_seconds],
            "raw_delay_samples": list(res.tgt_delay_samples),
            "clock_offset_samples": list(res.clock_offset_samples),
            "clock_drift_ppm": list(res.clock_drift_ppm),
            "quality": list(res.quality),
            "warnings": res.warnings,
            "excluded_stations": res.excluded_stations,
            "solve_weights": list(res.solve_weights),
            "candidates": [
                {"lat": c[0], "lon": c[1], "rms_m": r,
                 "power_score": None if fix.candidates_power_score is None
                 else fix.candidates_power_score[k]}
                for k, (c, r) in enumerate(
                    zip(fix.candidates_lla, fix.candidates_rms))
            ],
            "ghost": None if res.ghost is None else res.ghost.to_json(),
            "velocity_enu_mps": None if res.velocity_enu is None else
            list(res.velocity_enu),
            "velocity_sigma_mps": None if res.velocity_sigma_enu is None
            else list(res.velocity_sigma_enu),
            "velocity_residual_hz": res.velocity_residual_hz,
            "fdoa_hz": None if res.fdoa_hz is None else list(res.fdoa_hz),
            "emitters": None if res.emitters is None else [
                {"lat": e.fix.lat, "lon": e.fix.lon,
                 "rms_residual_m": e.fix.rms_residual_m,
                 "tdoa_samples": list(e.tdoa_samples),
                 "peak_value": list(e.peak_value),
                 "max_inconsistency_samples": e.max_inconsistency_samples,
                 "fdoa_hz": None if e.fdoa_hz is None else list(e.fdoa_hz),
                 "velocity_enu_mps": None if e.velocity_enu is None
                 else list(e.velocity_enu),
                 "velocity_sigma_mps": None if e.velocity_sigma_enu is None
                 else list(e.velocity_sigma_enu)}
                for e in res.emitters
            ],
        }))
        return 0
    print("\nPer-pair measurements:")
    for k, (i, j) in enumerate(res.pair_idx):
        print(
            f"  {names[i]:>8s} - {names[j]:<8s} "
            f"raw {res.tgt_delay_samples[k]:+9.2f}  "
            f"clock {res.clock_offset_samples[k]:+9.2f}  "
            f"TDOA {res.corrected_tdoa_samples[k]:+9.3f} samples "
            f"({res.tdoa_seconds[k]*1e6:+8.3f} us"
            f" ± {res.tdoa_std_s[k]*1e6:.3f})  quality {res.quality[k]:.1f}"
        )
    if np.abs(res.clock_drift_ppm).max() > 0.05:
        drifts = ", ".join(
            f"{names[i]}-{names[j]} {res.clock_drift_ppm[k]:+.2f} ppm"
            for k, (i, j) in enumerate(res.pair_idx)
        )
        print(f"  clock drift (from dual REF blocks): {drifts}")
    for w in res.warnings:
        print(f"  WARNING: {w}")
    print(f"\nPosition fix: {fix.lat:.6f}, {fix.lon:.6f}  "
          f"(elev {fix.elev:.0f} m, residual {fix.rms_residual_m:.1f} m)")
    if fix.ellipse is not None:
        maj, mnr, az = fix.ellipse
        print(f"1-sigma error ellipse: {maj:.1f} m x {mnr:.1f} m "
              f"at {az:.0f} deg E of N")
    if fix.candidates_lla is not None and len(fix.candidates_lla) > 1:
        print("Other candidate solutions (TDOA ghosts):")
        for lla, rms in zip(fix.candidates_lla[1:], fix.candidates_rms[1:]):
            print(f"  {lla[0]:.6f}, {lla[1]:.6f}  (residual {rms:.1f} m)")
    if res.velocity_enu is not None:
        ve, vn, _ = res.velocity_enu
        speed = math.hypot(ve, vn)
        heading = math.degrees(math.atan2(ve, vn)) % 360.0
        sig = ""
        if res.velocity_sigma_enu is not None:
            se, sn, _ = res.velocity_sigma_enu
            sig = f" ± ({se:.0f} E, {sn:.0f} N) m/s 1σ"
        print(f"Emitter velocity (FDOA): {speed:.1f} m/s "
              f"heading {heading:.0f} deg "
              f"(E {ve:+.1f}, N {vn:+.1f} m/s{sig}; "
              f"Doppler residual {res.velocity_residual_hz:.2f} Hz)")
    if res.emitters is not None and len(res.emitters) > 1:
        print(f"\nSeparated co-channel emitters ({len(res.emitters)}):")
        for n_e, e in enumerate(res.emitters):
            vtxt = ""
            if e.velocity_enu is not None:
                vtxt = (f", {math.hypot(e.velocity_enu[0], e.velocity_enu[1]):.0f}"
                        f" m/s")
            print(f"  emitter {n_e + 1}: {e.fix.lat:.6f}, {e.fix.lon:.6f}  "
                  f"(residual {e.fix.rms_residual_m:.1f} m, "
                  f"consistency {e.max_inconsistency_samples:.2f} samples"
                  f"{vtxt})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
