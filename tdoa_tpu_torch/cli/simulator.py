"""Ideal 3-station capture simulator CLI on the PyTorch/CUDA port —
simulator.go contract:

    python -m tdoa_tpu_torch.cli.simulator [--csv lat-lon-table.csv] \
        [--tx-lat .. --tx-lon .. --tx-elev ..] [--duration-s ..] [--out DIR]

Simulates on the card (``--device cpu`` for the CPU) and writes
``sim-{station}-{epoch}.dat`` files byte-compatible with the collector's
output (simulator.go:163-178), with physically true fractional-sample
delays, and prints the expected fix for verification.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# simulator.go:191-221 fallback station table (the Omaha deployment).
DEFAULT_STATIONS = {
    "kx0u": (41.18660274289527, -95.96064116595667, 355.69),
    "n3pay": (41.24669616513154, -96.08366304481238, 329.0),
    "kf0mtl": (41.32916620016985, -96.03513381562004, 373.18),
}
DEFAULT_REF_TX = (41.25703803095629, -95.95512763589404, 349.07)
DEFAULT_TGT_TX = (41.30888549464701, -96.02619229605524, 356.0)  # KEVO


def _add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--csv", default=None,
                   help="lat-lon-table.csv (default: built-in Omaha table)")
    p.add_argument("--ref-freq", type=float, default=162_400_000.0)
    p.add_argument("--tgt-freq", type=float, default=101_900_000.0)
    p.add_argument("--tx-lat", type=float, default=DEFAULT_TGT_TX[0])
    p.add_argument("--tx-lon", type=float, default=DEFAULT_TGT_TX[1])
    p.add_argument("--tx-elev", type=float, default=DEFAULT_TGT_TX[2])
    p.add_argument("--duration-s", type=float, default=1.5,
                   help="total capture duration (3 equal blocks)")
    p.add_argument("--sample-rate", type=float, default=2e6)
    p.add_argument("--clock-offsets-us", type=float, nargs="*", default=None,
                   help="per-station clock offsets in microseconds")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--interferer", type=float, nargs=4, default=None,
                   metavar=("LAT", "LON", "ELEV", "AMP"),
                   help="co-channel emitter on the target frequency: "
                        "position + amplitude relative to the target")
    p.add_argument("--velocity", type=float, nargs=3, default=None,
                   metavar=("VE", "VN", "VU"),
                   help="target emitter velocity, m/s ENU (moving-"
                        "emitter Doppler; see cli/caf_search + "
                        "solve/fdoa for the recovery path)")
    p.add_argument("--out", default=".", help="output directory")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; an error when "
                        "none is visible — pass cpu to run on the CPU)")


def build_scene(args, ref_profile, tgt_profile, block_len=None):
    from tdoa_tpu_torch.sim import SimScene

    if args.csv:
        from tdoa_tpu_torch.io import load_station_table

        table = load_station_table(args.csv, reference_freq=args.ref_freq)
        names = tuple(
            n for n in table.names if n.lower() not in ("kevo",)
        )
        lla = table.lla_array(names)
        ref_tx = (
            np.array([table.reference_tx.lat, table.reference_tx.lon,
                      table.reference_tx.elev])
            if table.reference_tx
            else np.array(DEFAULT_REF_TX)
        )
    else:
        names = tuple(DEFAULT_STATIONS)
        lla = np.array(list(DEFAULT_STATIONS.values()))
        ref_tx = np.array(DEFAULT_REF_TX)

    if block_len is None:
        block_len = int(args.duration_s * args.sample_rate / 3)
    offsets = None
    if args.clock_offsets_us:
        offsets = np.asarray(args.clock_offsets_us) * 1e-6
    return SimScene(
        station_names=names,
        station_lla=lla,
        ref_tx_lla=ref_tx,
        tgt_tx_lla=np.array([args.tx_lat, args.tx_lon, args.tx_elev]),
        ref_freq=args.ref_freq,
        tgt_freq=args.tgt_freq,
        sample_rate=args.sample_rate,
        block_len=block_len,
        clock_offsets_s=offsets,
        ref_profile=ref_profile,
        tgt_profile=tgt_profile,
        interferer_lla=(np.array(args.interferer[:3])
                        if args.interferer else None),
        interferer_amplitude=(args.interferer[3] if args.interferer else 0.0),
        tgt_velocity_enu=(np.array(args.velocity)
                          if args.velocity else None),
        seed=args.seed,
    )


def run_and_report(scene, out_dir: str, prefix: str, device=None) -> int:
    from tdoa_tpu_torch.sim import write_scene_captures

    epoch = int(time.time())
    try:
        paths, truth = write_scene_captures(scene, out_dir, prefix=prefix,
                                            epoch=epoch, device=device)
    except RuntimeError as e:  # no card visible and no --device
        print(f"error: {e}", file=sys.stderr)
        return 2
    for name, path in paths.items():
        print(f"  wrote {path}")
    print("\nGround truth TDOAs (samples):")
    for k, (i, j) in enumerate(truth.pair_idx):
        ni, nj = scene.station_names[i], scene.station_names[j]
        print(f"  {ni}-{nj}: {truth.tgt_tdoa_samples[k]:+.3f}")
    print(f"\nTransmitter at: {scene.tgt_tx_lla[0]:.6f}, {scene.tgt_tx_lla[1]:.6f}")
    if truth.tgt_fdoa_hz is not None and np.abs(truth.tgt_fdoa_hz).max() > 0:
        print("Ground truth FDOA (Hz, moving emitter):")
        for k, (i, j) in enumerate(truth.pair_idx):
            ni, nj = scene.station_names[i], scene.station_names[j]
            print(f"  {ni}-{nj}: {truth.tgt_fdoa_hz[k]:+.2f}")
    files = " ".join(paths.values())
    print(f"Test with:\n  python -m tdoa_tpu_torch.cli.processor "
          f"{scene.ref_freq:.0f} {scene.tgt_freq:.0f} lat-lon-table.csv {files}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="simulator", description="Ideal 3-station TDOA capture simulator"
    )
    _add_common_args(p)
    args = p.parse_args(argv)

    from tdoa_tpu_torch.sim import IDEAL_PROFILE

    scene = build_scene(args, IDEAL_PROFILE, IDEAL_PROFILE)
    print(f"Simulating {len(scene.station_names)} stations, "
          f"{3*scene.block_len/scene.sample_rate:.1f} s at "
          f"{scene.sample_rate/1e6:.1f} Msps")
    return run_and_report(scene, args.out, "sim-", device=args.device)


if __name__ == "__main__":
    sys.exit(main())
