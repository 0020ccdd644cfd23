"""Deep signal-quality analyzer CLI on the PyTorch/CUDA port —
analyzer.go contract:

    python -m tdoa_tpu_torch.cli.analyzer <file.dat> [--device cpu]

Per-signal (REF vs TGT) metrics, recommendations, TDOA suitability verdict.
"""

from __future__ import annotations

import argparse
import sys

from tdoa_tpu_torch.cli import tool_device


def _print_block(name: str, s) -> None:
    print(f"\n=== {name} signal ===")
    print(f"  SNR: {s.snr_db:.1f} dB")
    print(f"  Power: {s.power:.3e} (RMS {s.rms:.4f})")
    print(f"  DC offset: I {s.dc_offset_i:+.2f}, Q {s.dc_offset_q:+.2f} (bytes)")
    print(f"  I/Q imbalance: {s.iq_imbalance_db:+.2f} dB")
    print(f"  Byte range: [{s.min_byte}, {s.max_byte}]")
    print(f"  Clipping: {s.clip_fraction*100:.3f}%   "
          f"Overload: {s.overload_fraction*100:.2f}%   "
          f"Dead: {s.dead_fraction*100:.1f}%")
    flags = [f for f, on in [("CLIPPING", s.is_clipping),
                             ("OVERLOADED", s.is_overloaded),
                             ("DEAD", s.is_dead),
                             ("NOISY", s.is_noisy)] if on]
    if flags:
        print(f"  Flags: {', '.join(flags)}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="analyzer",
        description="Deep dual-frequency signal quality analysis",
    )
    p.add_argument("dat_file")
    p.add_argument("--nfft", type=int, default=8192)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; pass cpu to run "
                        "on the CPU)")
    args = p.parse_args(argv)
    device = tool_device(args.device)
    if device is None:
        return 2

    from tdoa_tpu_torch.quality import (
        analyze_capture,
        assess_tdoa_suitability,
        compare_signals,
        generate_recommendations,
    )

    a = analyze_capture(args.dat_file, nfft=args.nfft, device=device)
    print(f"Analyzing {args.dat_file}")
    _print_block("REFERENCE", a.ref)
    _print_block("TARGET", a.tgt)

    print("\n=== Signal comparison ===")
    for line in compare_signals(a):
        print(f"  {line}")

    print("\n=== Recommendations ===")
    for r in generate_recommendations(a):
        print(f"  {r}")

    ok, problems = assess_tdoa_suitability(a)
    print("\n=== TDOA suitability ===")
    if ok:
        print("  SUITABLE for TDOA processing")
    else:
        for prob in problems:
            print(f"  - {prob}")
        print("  NOT suitable for TDOA processing")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
