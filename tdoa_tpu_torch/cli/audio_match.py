"""Audio-pattern-matching CLI on the PyTorch/CUDA port — the reference
contract:

    python -m tdoa_tpu_torch.cli.audio_match <ref_freq> <target_freq> \
        <stations.csv> <recording.wav> <dat1> <dat2> <dat3> [...]

Predicts the FM RF pattern the recorded audio generates, matched-filters
every station's TGT block against it for a per-station time-of-arrival,
clock-corrects the TOA differences with the dual-REF measurement, and
solves the fix. The standard pairwise pipeline runs alongside for
cross-validation. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="audio_match",
        description="Matched-filter TDOA from a known audio recording",
    )
    p.add_argument("ref_freq", type=float, help="reference frequency, Hz")
    p.add_argument("target_freq", type=float, help="target frequency, Hz")
    p.add_argument("csv", help="lat-lon-table.csv station geometry")
    p.add_argument("wav", help="recorded target audio (uncompressed WAV)")
    p.add_argument("dat_files", nargs="+", help=".dat capture files (>= 3)")
    p.add_argument("--match-mode", default="auto",
                   choices=["auto", "audio", "rf"],
                   help="auto (default): demodulated-audio correlation "
                        "with escalation to the rf-domain filter when "
                        "the audio match fails validation; audio: "
                        "LO-immune audio correlation only; rf: the "
                        "predicted RF pattern with a per-station "
                        "LO-offset search")
    p.add_argument("--deviation", type=float, default=25000.0,
                   help="FM deviation constant k_f, Hz full-scale "
                        "(default 25 kHz — NBFM)")
    p.add_argument("--decim", type=int, default=8,
                   help="audio decimation for --match-mode audio "
                        "(divides 128)")
    p.add_argument("--lo-span", type=float, default=200.0,
                   help="±LO-offset search span for --match-mode rf, Hz")
    p.add_argument("--max-lag", type=int, default=20000,
                   help="TOA search window, samples (default 20000)")
    p.add_argument("--seg-len", type=int, default=1 << 16,
                   help="correlation segment length")
    p.add_argument("--weighting", default="ht",
                   choices=["ht", "ml", "phat", "scot", "none"],
                   help="GCC weighting for the pairwise/clock pass")
    p.add_argument("--truncate-s", type=float, default=None,
                   help="process only the first S seconds of each block")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; an error when "
                        "none is visible — pass cpu to run on the CPU)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable JSON to stdout")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    from tdoa_tpu_torch.io.wav import read_wav
    from tdoa_tpu_torch.pipeline import TDOAProcessor
    from tdoa_tpu_torch.pipeline.audio_match import match_captures
    from tdoa_tpu_torch.utils.constants import DEFAULT_SAMPLE_RATE

    out = sys.stderr if args.json else sys.stdout
    trunc = (
        int(args.truncate_s * DEFAULT_SAMPLE_RATE)
        if args.truncate_s is not None else None
    )
    try:
        proc = TDOAProcessor.from_csv(
            args.ref_freq, args.target_freq, args.csv, device=args.device,
            max_lag=args.max_lag, seg_len=args.seg_len,
            weighting=args.weighting, truncate_samples=trunc,
        )
    except RuntimeError as e:  # no card visible and no --device
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        audio_fs, audio = read_wav(args.wav)
        captures = proc.load_files(args.dat_files)
        res = match_captures(
            proc, captures, audio, audio_fs,
            mode=args.match_mode, deviation_hz=args.deviation,
            decim=args.decim, lo_span_hz=args.lo_span,
        )
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    names = res.station_names
    if args.json:
        import json

        fix = res.fix
        pw = res.pairwise
        print(json.dumps({
            "fix": {"lat": fix.lat, "lon": fix.lon, "elev": fix.elev,
                    "rms_residual_m": fix.rms_residual_m,
                    "ellipse_1sigma_m": None if fix.ellipse is None else
                    {"semi_major": fix.ellipse[0],
                     "semi_minor": fix.ellipse[1],
                     "azimuth_deg": fix.ellipse[2]}},
            "stations": names,
            "toa_samples": list(res.toa_samples),
            "toa_std_samples": list(res.toa_std_samples),
            "station_quality": list(res.station_quality),
            "lo_offset_hz": None if res.lo_offset_hz is None
            else list(res.lo_offset_hz),
            "pairs": [[names[i], names[j]] for i, j in res.pair_idx],
            "tdoa_us": [s * 1e6 for s in res.tdoa_seconds],
            "tdoa_std_us": [s * 1e6 for s in res.tdoa_std_s],
            "pairwise_tdoa_us": [s * 1e6 for s in pw.tdoa_seconds],
            "pairwise_fix": {"lat": pw.fix.lat, "lon": pw.fix.lon},
            "covered_fraction": res.covered_fraction,
            "mode_used": res.mode_used,
            "warnings": res.warnings + pw.warnings,
        }))
        return 0

    print(f"Audio template: {args.wav} "
          f"({res.covered_fraction:.0%} of the target window, "
          f"mode={res.mode_used}, on {proc.device})", file=out)
    print("\nPer-station template TOA:", file=out)
    for i, n in enumerate(names):
        lo = ("" if res.lo_offset_hz is None
              else f"  LO {res.lo_offset_hz[i]:+7.2f} Hz")
        print(f"  {n:10s} {res.toa_samples[i]:12.3f} samples "
              f"(±{res.toa_std_samples[i]:.3f})  "
              f"PSR {res.station_quality[i]:6.1f}{lo}", file=out)
    print("\nPer-pair TDOA (clock-corrected):", file=out)
    for k, (i, j) in enumerate(res.pair_idx):
        pw_us = res.pairwise.tdoa_seconds[k] * 1e6
        print(f"  {names[i]}-{names[j]}: "
              f"{res.tdoa_seconds[k]*1e6:10.3f} us "
              f"(±{res.tdoa_std_s[k]*1e6:.3f})   "
              f"pairwise {pw_us:10.3f} us", file=out)
    fix = res.fix
    print(f"\nTemplate fix: {fix.lat:.6f}, {fix.lon:.6f}  "
          f"(rms {fix.rms_residual_m:.1f} m)", file=out)
    pwf = res.pairwise.fix
    print(f"Pairwise fix: {pwf.lat:.6f}, {pwf.lon:.6f}  "
          f"(rms {pwf.rms_residual_m:.1f} m)", file=out)
    for w in res.warnings + res.pairwise.warnings:
        print(f"warning: {w}", file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
