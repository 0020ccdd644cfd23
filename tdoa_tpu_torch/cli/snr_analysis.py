"""Link-budget calculator CLI — snr_analysis.go capability: static SNR
analysis from measured station powers, requirement tiers, and the
coherent-integration gain table. Pure arithmetic, as in
``tdoa_tpu.cli.snr_analysis``: no tensor, no device.

    python -m tdoa_tpu_torch.cli.snr_analysis [--powers kx0u=2.72e-3 ...]
"""

from __future__ import annotations

import argparse
import math
import sys

# snr_analysis.go:13-15 — one field run's measured REF powers (rel. full scale)
DEFAULT_POWERS = {"kx0u": 2.72e-3, "n3pay": 7.57e-5, "kf0mtl": 5.15e-3}
NOISE_FLOOR_DB = -55.0  # snr_analysis.go:32
# snr_analysis.go:42-48 requirement tiers
TIERS = [
    (15.0, "basic correlation detection"),
    (20.0, "precise TDOA measurement"),
    (25.0, "sub-sample interpolation"),
    (30.0, "high-precision sub-sample TDOA"),
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="snr_analysis")
    p.add_argument("--powers", nargs="*", default=None,
                   metavar="NAME=POWER",
                   help="station REF powers relative to full scale "
                        "(default: the reference's field measurements)")
    p.add_argument("--noise-floor-db", type=float, default=NOISE_FLOOR_DB)
    args = p.parse_args(argv)

    powers = dict(DEFAULT_POWERS)
    if args.powers:
        powers = {}
        for spec in args.powers:
            name, val = spec.split("=")
            powers[name] = float(val)

    print("=== Station link budget ===")
    print(f"Assumed noise floor: {args.noise_floor_db:.0f} dBFS\n")
    for name, pw in powers.items():
        sig_db = 10 * math.log10(max(pw, 1e-30))
        snr = sig_db - args.noise_floor_db
        print(f"{name:>8s}: power {pw:.2e} = {sig_db:6.1f} dBFS -> "
              f"SNR {snr:5.1f} dB")
        for req, desc in TIERS:
            status = "OK  " if snr >= req else (
                f"need +{req - snr:.1f} dB")
            print(f"            {req:4.0f} dB ({desc:32s}): {status}")
        deficit = max((req - snr for req, _ in TIERS), default=0)
        if deficit > 0:
            t_ms = 10 ** (deficit / 10)
            print(f"            coherent integration to close the gap: "
                  f"~{t_ms:.1f} ms")
        print()

    # snr_analysis.go:83-88 integration gain table
    print("=== Coherent integration gain (10*log10 t) ===")
    for t_ms in (1, 10, 100, 1000):
        print(f"  {t_ms:5d} ms -> +{10*math.log10(t_ms):4.1f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
