"""Collection orchestrator CLI on the PyTorch/CUDA port — collector.go
contract (collector.go:22-28):

    python -m tdoa_tpu_torch.cli.collector [--duration D] \
        [--gain1 G --gain2 G] [--torch-device cpu] \
        <ref_freq> <target_freq> <start_epoch> <station_id>

Waits for the epoch start, runs the capture backend, writes
``{station}-{epoch}.dat``, then validates the file (size + 3-block power
consistency, collector.go:178-248).

Backends:
- ``--backend native`` (default when built): the C++ ``sdr_capture`` tool
  (capture/, the librtlsdr-2freq replacement) as a subprocess —
  the same process boundary as collector.go:124-163;
- ``--backend sim``: hardware-free capture via the port's scene
  simulator (``tdoa_tpu_torch.sim``, on the torch device), for end-to-end
  rehearsal.

The window's validation (``quality.validate_dat_structure``) runs on the
torch device too: the card unless ``--torch-device cpu`` is given
(``--device`` is the USB dongle index, as in the reference).

Service mode: ``--repeat N --interval S`` collects N epoch-aligned
windows (N=0: forever), one capture every S seconds. With
``start_epoch 0`` the first window self-aligns to the next multiple of
the interval, so independent stations sharing only NTP and the same
CLI arguments produce identically-stamped ``{station}-{epoch}.dat``
windows — point ``stream_processor --watch`` at the output directory
for a continuous live geolocation service (the loop the reference
leaves to humans/cron, docs/usage.md:21-52).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from tdoa_tpu_torch.cli import tool_device

MAX_DURATION_S = 100  # collector.go:31-34
SAMPLE_RATE = 2_000_000


def _native_tool() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    return os.path.join(here, "capture", "build", "sdr_capture")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="collector")
    p.add_argument("ref_freq", type=float)
    p.add_argument("target_freq", type=float)
    p.add_argument("start_epoch", type=int,
                   help="unix epoch second to start capture (0 = now)")
    p.add_argument("station_id")
    p.add_argument("--duration", type=int, default=30,
                   help="total capture seconds (max 100)")
    p.add_argument("--gain", type=float, default=None,
                   help="single gain for both frequencies")
    p.add_argument("--gain1", type=float, default=28.0)
    p.add_argument("--gain2", type=float, default=28.0)
    p.add_argument("--backend", choices=["native", "sim"], default=None)
    p.add_argument("--tcp", default=None, metavar="HOST:PORT",
                   help="capture from an rtl_tcp-protocol server instead "
                        "of local hardware (native backend)")
    p.add_argument("--usb", action="store_true",
                   help="capture from a directly-attached RTL2832U "
                        "dongle over libusb (native backend)")
    p.add_argument("--ppm", type=int, default=0, metavar="PPM",
                   help="frequency-correction ppm forwarded to the native "
                        "capture tool (-p); measure with sdr_test -p")
    p.add_argument("--device", type=int, default=0, metavar="N",
                   help="USB dongle index for --usb (default 0)")
    p.add_argument("--csv", default="lat-lon-table.csv",
                   help="station table (sim backend geometry)")
    p.add_argument("--out", default=".")
    p.add_argument("--torch-device", default=None, metavar="DEV",
                   help="torch device of the simulator and the validation "
                        "(default: the card; pass cpu to run on the CPU)")
    p.add_argument("--repeat", type=int, default=1, metavar="N",
                   help="collect N epoch-aligned windows (0 = forever); "
                        "each writes its own {station}-{epoch}.dat")
    p.add_argument("--interval", type=int, default=None, metavar="S",
                   help="seconds between window starts in --repeat mode "
                        "(default: duration + 2; must exceed duration)")
    args = p.parse_args(argv)
    args.torch_device = tool_device(args.torch_device, "--torch-device")
    if args.torch_device is None:
        return 2

    if args.duration > MAX_DURATION_S:
        print(f"duration capped at {MAX_DURATION_S} s")
        args.duration = MAX_DURATION_S
    g1 = args.gain if args.gain is not None else args.gain1
    g2 = args.gain if args.gain is not None else args.gain2

    backend = args.backend
    if backend is None:
        backend = "native" if os.path.exists(_native_tool()) else "sim"

    repeat = args.repeat
    interval = args.interval
    if interval is None:
        interval = args.duration + 2
    if repeat != 1 and interval <= args.duration:
        print(f"--interval {interval} must exceed --duration "
              f"{args.duration}")
        return 2

    if args.start_epoch:
        epoch = args.start_epoch
    elif repeat == 1:
        epoch = int(time.time())
    else:
        # Self-align to the next interval multiple: stations sharing
        # NTP + these arguments pick identical epochs with no rendezvous.
        epoch = (int(time.time()) // interval + 1) * interval

    ok_windows = 0
    window = 0
    while True:
        rc = _capture_window(args, backend, epoch, g1, g2)
        if rc == 0:
            ok_windows += 1
        elif repeat == 1:
            return rc
        window += 1
        if repeat and window >= repeat:
            break
        epoch, missed = _next_epoch(epoch, interval, time.time())
        if missed:
            print(f"WARNING: missed {missed} window(s) "
                  f"(capture overran the interval)")
    if repeat != 1:
        print(f"Service done: {ok_windows}/{window} windows valid")
        return 0 if ok_windows else 1
    return 0


def _next_epoch(epoch: int, interval: int, now: float):
    """Next grid epoch strictly in the future: a window that overran
    its slot skips ahead on the fixed grid (epoch0 + k*interval)
    rather than drifting it. Returns (next_epoch, windows_missed)."""
    epoch += interval
    missed = 0
    while epoch <= now:
        epoch += interval
        missed += 1
    return epoch, missed


def _capture_window(args, backend, epoch, g1, g2) -> int:
    """One epoch-stamped capture + validation (collector.go:113-248)."""
    out_path = os.path.join(args.out, f"{args.station_id}-{epoch}.dat")
    samples_per_freq = args.duration * SAMPLE_RATE // 3

    # Busy-wait for the start second (collector.go:113-116).
    now = time.time()
    if epoch > now:
        print(f"Waiting {epoch - now:.1f} s for start epoch {epoch}...")
        while time.time() < epoch:
            time.sleep(0.05)

    t0 = time.time()
    if backend == "native":
        cmd = [
            _native_tool(),
            "-f", f"{args.ref_freq:.0f}",
            "-h", f"{args.target_freq:.0f}",
            "-s", str(SAMPLE_RATE),
            "-1", f"{g1:.1f}",
            "-2", f"{g2:.1f}",
            "-n", str(samples_per_freq),
        ]
        if args.ppm:
            cmd += ["-p", str(args.ppm)]
        if args.usb:
            cmd += ["--usb", "-d", str(args.device)]
        elif args.tcp:
            cmd += ["--tcp", args.tcp]
        cmd.append(out_path)
        print("Running:", " ".join(cmd))
        rc = subprocess.call(cmd)
        if rc != 0:
            print(f"capture tool failed (exit {rc})")
            return rc
    else:
        print(f"[sim backend] generating {args.duration}s capture for "
              f"{args.station_id}")
        import numpy as np

        from tdoa_tpu_torch.cli.simulator import (
            DEFAULT_REF_TX,
            DEFAULT_STATIONS,
            DEFAULT_TGT_TX,
        )
        from tdoa_tpu_torch.io.datfile import save_dat
        from tdoa_tpu_torch.sim import SimScene, simulate_scene

        names = tuple(DEFAULT_STATIONS)
        if args.station_id not in names:
            names = names + (args.station_id,)
            stations = dict(DEFAULT_STATIONS)
            stations[args.station_id] = DEFAULT_STATIONS["kx0u"]
        else:
            stations = DEFAULT_STATIONS
        scene = SimScene(
            station_names=tuple(stations),
            station_lla=np.array(list(stations.values())),
            ref_tx_lla=np.array(DEFAULT_REF_TX),
            tgt_tx_lla=np.array(DEFAULT_TGT_TX),
            ref_freq=args.ref_freq,
            tgt_freq=args.target_freq,
            # Honor the requested duration exactly — a silent cap here
            # once produced 3 s captures for a requested 30 s while
            # printing success.
            block_len=samples_per_freq,
            seed=epoch % (1 << 31),
        )
        captures, _ = simulate_scene(scene, device=args.torch_device)
        r1, tg, r2 = captures[args.station_id]
        save_dat(out_path, r1, tg, r2)

    dt = time.time() - t0
    print(f"Capture complete in {dt*1e3:.0f} ms -> {out_path}")

    # Validation (collector.go:178-248 semantics via the quality module).
    from tdoa_tpu_torch.quality import validate_dat_structure

    rep = validate_dat_structure(
        out_path,
        expected_duration_s=args.duration,
        sample_rate=SAMPLE_RATE,
        device=args.torch_device,
    )
    if rep.problems:
        for prob in rep.problems:
            print(f"  VALIDATION: {prob}")
        print("Capture FAILED validation")
        return 1
    print(f"Validated: {rep.samples_total:,} samples, "
          f"3x{rep.samples_per_block:,} blocks, REF power consistent")
    return 0


if __name__ == "__main__":
    sys.exit(main())
