"""Correlation sanity harness CLI on the PyTorch/CUDA port —
simple_corr.go contract: three self-contained checks with explicit
PASS/FAIL output (simple_corr.go:31-80):

1. self-correlation of a synthetic tone ≈ 1;
2. delayed-signal recovery within tolerance;
3. correlation against independent noise ≈ 0.

    python -m tdoa_tpu_torch.cli.simple_corr [--device cpu]

The signals are drawn from seeded ``torch.Generator``s on the device that
runs the checks.
"""

from __future__ import annotations

import argparse
import sys

from tdoa_tpu_torch.cli import tool_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="simple_corr")
    p.add_argument("--n", type=int, default=1 << 15)
    p.add_argument("--delay", type=float, default=100.25)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; pass cpu to run "
                        "on the CPU)")
    args = p.parse_args(argv)
    device = tool_device(args.device)
    if device is None:
        return 2

    import torch

    from tdoa_tpu_torch.ops.corr import correlate_two
    from tdoa_tpu_torch.sim import fm_source, fractional_delay

    ok = True
    sig = fm_source(args.n, 2e6,
                    torch.Generator(device=device).manual_seed(0))

    # Test 1: self-correlation (reference expects > 0.8; exact math gives 1)
    r = correlate_two(sig, sig, max_lag=256, weighting="none")
    passed = abs(float(r.peak_value) - 1.0) < 1e-2 and abs(float(r.delay)) < 0.01
    ok &= passed
    print(f"Test 1 self-correlation: peak {float(r.peak_value):.4f} at "
          f"delay {float(r.delay):+.3f}  "
          f"{'PASS' if passed else 'FAIL'}")

    # Test 2: delayed-signal recovery (reference tolerance ±10 samples;
    # the rebuild holds ±0.05)
    delayed = fractional_delay(sig, args.delay)
    r = correlate_two(sig, delayed, max_lag=max(256, int(abs(args.delay)) + 64))
    err = abs(float(r.delay) - args.delay)
    passed = err < 0.05
    ok &= passed
    print(f"Test 2 delay recovery: found {float(r.delay):+.3f} "
          f"(want {args.delay:+.3f}, err {err:.4f})  "
          f"{'PASS' if passed else 'FAIL'}")

    # Test 3: noise correlation (reference expects < 0.2)
    g = torch.Generator(device=device).manual_seed(1)
    noise = torch.complex(
        torch.randn(args.n, generator=g, device=device),
        torch.randn(args.n, generator=g, device=device))
    r = correlate_two(sig, noise, max_lag=256, weighting="none")
    passed = float(r.peak_value) < 0.2
    ok &= passed
    print(f"Test 3 noise rejection: peak {float(r.peak_value):.4f}  "
          f"{'PASS' if passed else 'FAIL'}")

    print("ALL PASS" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
