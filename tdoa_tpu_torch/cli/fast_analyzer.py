"""Fast analyzer CLI on the PyTorch/CUDA port — fast_analyzer.go contract:
machine-readable CSV lines ``REF,snr,power,clip,ovl`` / ``TGT,...`` for
calibration scripting:

    python -m tdoa_tpu_torch.cli.fast_analyzer <file.dat> [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from tdoa_tpu_torch.cli import tool_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fast_analyzer")
    p.add_argument("dat_file")
    p.add_argument("--nfft", type=int, default=8192,
                   help="FFT size (reference used 8192-pt)")
    p.add_argument("--max-samples", type=int, default=32768,
                   help="samples per block to analyze "
                        "(reference used 32768)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; pass cpu to run "
                        "on the CPU)")
    args = p.parse_args(argv)
    device = tool_device(args.device)
    if device is None:
        return 2

    from tdoa_tpu_torch.quality import analyze_capture
    from tdoa_tpu_torch.quality.analyzer import fast_csv_line

    a = analyze_capture(args.dat_file, nfft=args.nfft,
                        max_samples_per_block=args.max_samples, device=device)
    print(fast_csv_line(a))
    return 0


if __name__ == "__main__":
    sys.exit(main())
