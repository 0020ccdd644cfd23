"""Gain calibration CLI on the PyTorch/CUDA port — gain_calibrator.go
contract:

    python -m tdoa_tpu_torch.cli.gain_calibrator <ref_freq> <target_freq> \
        [--torch-device cpu]

Binary-searches tuner gain into the 18–40 dB SNR band for each frequency
(≤8 test captures each), printing the recommended collector command. Uses
the native capture backend when built, else the simulated receiver.
Each test capture is analyzed on the torch device: the card unless
``--torch-device cpu`` is given (``--device`` is the USB dongle index, as
in the reference).
"""

from __future__ import annotations

import argparse
import os
import sys

from tdoa_tpu_torch.cli import tool_device
from tdoa_tpu_torch.cli.collector import _native_tool


class NativeCaptureBackend:
    """Short test captures via the C++ sdr_capture tool (the reference
    spawned ./collector + ./fast_analyzer, gain_calibrator.go:185-237)."""

    def __init__(self, tool: str, extra_args=()):
        self.tool = tool
        self.extra_args = list(extra_args)

    def capture(self, freq_hz: float, gain_db: float, n_samples: int):
        import subprocess
        import tempfile

        import numpy as np

        with tempfile.NamedTemporaryFile(suffix=".dat", delete=False) as f:
            path = f.name
        try:
            # freq+100 kHz as the dummy second frequency
            # (gain_calibrator.go:199-210).
            subprocess.check_call(
                [
                    self.tool,
                    "-f", f"{freq_hz:.0f}",
                    "-h", f"{freq_hz + 100e3:.0f}",
                    "-1", f"{gain_db:.1f}",
                    "-2", f"{gain_db:.1f}",
                    "-n", str(n_samples),
                    *self.extra_args,
                    path,
                ]
            )
            raw = np.fromfile(path, dtype=np.uint8, count=2 * n_samples)
            return raw
        finally:
            os.unlink(path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gain_calibrator")
    p.add_argument("ref_freq", type=float)
    p.add_argument("target_freq", type=float)
    p.add_argument("--backend", choices=["native", "sim"], default=None)
    p.add_argument("--usb", action="store_true",
                   help="calibrate a directly-attached RTL2832U dongle "
                        "(native backend)")
    p.add_argument("--device", type=int, default=0, metavar="N",
                   help="USB dongle index for --usb (default 0)")
    p.add_argument("--tcp", default=None, metavar="HOST:PORT",
                   help="calibrate through an rtl_tcp-protocol server "
                        "(native backend)")
    p.add_argument("--torch-device", default=None, metavar="DEV",
                   help="torch device of the analysis (default: the card; "
                        "pass cpu to run on the CPU)")
    args = p.parse_args(argv)
    device = tool_device(args.torch_device, "--torch-device")
    if device is None:
        return 2

    from tdoa_tpu_torch.calib import SimCaptureBackend

    backend_kind = args.backend
    if backend_kind is None:
        backend_kind = "native" if os.path.exists(_native_tool()) else "sim"
    if backend_kind == "native":
        extra = []
        if args.usb:
            extra = ["--usb", "-d", str(args.device)]
        elif args.tcp:
            extra = ["--tcp", args.tcp]
        backend = NativeCaptureBackend(_native_tool(), extra)
    else:
        print("[sim backend] calibrating against the simulated receiver")
        backend = SimCaptureBackend()

    print(f"Calibrating reference frequency {args.ref_freq/1e6:.4f} MHz")
    from tdoa_tpu_torch.calib import calibrate_frequency

    ref = calibrate_frequency(backend, args.ref_freq, verbose=True,
                              device=device)
    print(f"Calibrating target frequency {args.target_freq/1e6:.4f} MHz")
    tgt = calibrate_frequency(backend, args.target_freq, verbose=True,
                              device=device)

    for name, res in (("REF", ref), ("TGT", tgt)):
        status = "converged" if res.converged else "best effort"
        print(f"{name}: gain {res.gain_db:.1f} dB -> SNR {res.snr_db:.1f} dB "
              f"({status}, {res.iterations} iterations)")
    print("\nRecommended collection command:")
    print(f"  python -m tdoa_tpu_torch.cli.collector "
          f"--gain1 {ref.gain_db:.1f} --gain2 {tgt.gain_db:.1f} "
          f"{args.ref_freq:.0f} {args.target_freq:.0f} <epoch> <station>")
    return 0


if __name__ == "__main__":
    sys.exit(main())
