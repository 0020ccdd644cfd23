"""Pipeline-level correlation sanity CLI on the PyTorch/CUDA port —
correlation_sanity.go contract: correlate a real ``.dat`` capture's REF
signal with itself through the *actual* processing pipeline and expect
≈1.0 at delay 0 (correlation_sanity.go:44-64):

    python -m tdoa_tpu_torch.cli.correlation_sanity <file.dat> [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from tdoa_tpu_torch.cli import tool_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="correlation_sanity")
    p.add_argument("dat_file")
    p.add_argument("--max-samples", type=int, default=1 << 20)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; pass cpu to run "
                        "on the CPU)")
    args = p.parse_args(argv)
    device = tool_device(args.device)
    if device is None:
        return 2

    import numpy as np
    import torch

    from tdoa_tpu_torch.io import load_dat
    from tdoa_tpu_torch.ops.corr import correlate_pairs_planar

    cap = load_dat(args.dat_file, device=device)
    ref = cap.ref1  # planar [2, L]
    print(f"Loaded {args.dat_file}: {int(ref.shape[-1]):,} samples/block")
    n = min(args.max_samples, int(ref.shape[-1]))
    x = torch.stack([ref[:, :n], ref[:, :n]], dim=1)  # [2, 2, n]
    res = correlate_pairs_planar(x, np.array([[0, 1]]), max_lag=1024,
                                 weighting="none")
    peak = float(res.peak_value[0])
    delay = float(res.delay[0])
    print(f"Self-correlation peak {peak:.6f} at delay {delay:+.4f} samples")
    ok = abs(peak - 1.0) < 1e-3 and abs(delay) < 0.01
    print("PASS" if ok else "FAIL (pipeline is corrupting the signal)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
