"""Data-validation CLI on the PyTorch/CUDA port — reader.go contract:

    python -m tdoa_tpu_torch.cli.reader <file.dat> [expected_duration_s] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from tdoa_tpu_torch.cli import tool_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="reader", description="Structural validation of a .dat capture"
    )
    p.add_argument("dat_file")
    p.add_argument("expected_duration", nargs="?", type=float, default=None,
                   help="expected capture duration, seconds")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; pass cpu to run "
                        "on the CPU)")
    args = p.parse_args(argv)
    device = tool_device(args.device)
    if device is None:
        return 2

    from tdoa_tpu_torch.quality import validate_dat_structure

    rep = validate_dat_structure(args.dat_file, args.expected_duration,
                                 device=device)
    print(f"File: {rep.path}")
    print(f"  Size: {rep.size_bytes:,} bytes "
          f"({rep.samples_total:,} samples, {rep.duration_s:.2f} s)")
    print(f"  3-block pattern: "
          f"{'OK' if rep.three_block_pattern_ok else 'BROKEN'} "
          f"({rep.samples_per_block:,} samples/block)")
    for i, s in enumerate(rep.block_stats):
        label = ["REF1", "TGT ", "REF2"][i] if len(rep.block_stats) == 3 else str(i)
        print(f"  Block {label}: power {s.power:.3e}  SNR {s.snr_db:5.1f} dB  "
              f"DC ({s.dc_offset_i:+.1f},{s.dc_offset_q:+.1f})  "
              f"range [{s.min_byte},{s.max_byte}]"
              f"{'  CLIPPING' if s.is_clipping else ''}"
              f"{'  DEAD' if s.is_dead else ''}")
    print(f"  REF power consistency: "
          f"{'OK' if rep.ref_power_consistent else 'INCONSISTENT'}")
    if rep.problems:
        print("Problems:")
        for prob in rep.problems:
            print(f"  - {prob}")
        print("RESULT: FAIL")
        return 1
    print("RESULT: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
