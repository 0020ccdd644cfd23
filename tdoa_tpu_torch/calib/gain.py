"""Closed-loop automatic gain calibration — gain_calibrator.go capability
(torch port of ``tdoa_tpu.calib.gain``).

The reference binary-searches tuner gain in [5, 45] dB targeting an
18–40 dB SNR band with ≤8 two-second test captures per frequency
(gain_calibrator.go:12-21, 90-176), spawning ./collector and
./fast_analyzer subprocesses. Here the loop drives a ``CaptureBackend``
protocol instead of subprocesses — the simulator backend makes the whole
loop testable without hardware, and a native capture backend slots in
identically (process boundaries replaced by function calls; the analysis
runs as one device pass, ``quality.analyze_block_bytes``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Tuple

import numpy as np
import torch

from tdoa_tpu_torch.io.datfile import iq_to_bytes
from tdoa_tpu_torch.quality.analyzer import BlockStats, analyze_block_bytes
from tdoa_tpu_torch.utils.platform import default_device


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """gain_calibrator.go:12-21 constants."""

    min_gain_db: float = 5.0
    max_gain_db: float = 45.0
    target_snr_lo_db: float = 18.0
    target_snr_hi_db: float = 40.0
    max_iterations: int = 8
    test_samples: int = 1 << 16  # the 2 s test capture, scaled for sim


@dataclasses.dataclass
class CalibrationResult:
    freq_hz: float
    gain_db: float
    snr_db: float
    converged: bool
    iterations: int
    history: List[Tuple[float, float]]  # (gain, snr) per iteration


class CaptureBackend(Protocol):
    """Anything that can do a short test capture at (freq, gain) and hand
    back the raw u8 bytes (the .dat byte contract)."""

    def capture(self, freq_hz: float, gain_db: float, n_samples: int) -> np.ndarray:
        ...


class SimCaptureBackend:
    """Simulated receiver with a gain-dependent signal/noise model:
    signal level scales with gain; past ``overload_gain_db`` the ADC
    clips. Lets the calibrator tests exercise every branch (too-low SNR,
    in-band, clipping) without hardware. Host numpy, drawn exactly as
    the JAX package's backend draws: the same seed gives the same
    bytes."""

    def __init__(
        self,
        # -2 dBFS at 40 dB gain: full scale (clipping) is crossed right
        # at overload_gain_db, so the calibrator's clip branch is
        # actually reachable in simulation.
        signal_dbfs_at_40: float = -2.0,
        noise_floor_dbfs: float = -55.0,  # snr_analysis.go:32
        overload_gain_db: float = 42.0,
        seed: int = 0,
    ):
        self.signal_dbfs_at_40 = signal_dbfs_at_40
        self.noise_floor_dbfs = noise_floor_dbfs
        self.overload_gain_db = overload_gain_db
        self.seed = seed

    def capture(self, freq_hz: float, gain_db: float, n_samples: int) -> np.ndarray:
        rng = np.random.default_rng(
            self.seed + int(freq_hz) % 100_000 + int(gain_db * 10)
        )
        t = np.arange(n_samples)
        # Narrowband signal whose amplitude follows gain.
        amp = 10 ** ((self.signal_dbfs_at_40 + (gain_db - 40.0)) / 20.0)
        tone = amp * np.exp(2j * np.pi * 0.05 * t + 1j * rng.uniform(0, 2 * np.pi))
        # Noise floor rises weakly with gain (LNA noise).
        namp = 10 ** ((self.noise_floor_dbfs + 0.3 * (gain_db - 40.0)) / 20.0)
        noise = namp * (rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples))
        x = tone + noise
        if gain_db > self.overload_gain_db:
            x = np.clip(x.real, -1, 1) + 1j * np.clip(x.imag, -1, 1)
        return iq_to_bytes(x.astype(np.complex64))


def _measure(backend: CaptureBackend, freq: float, gain: float, n: int,
             device: torch.device) -> BlockStats:
    raw = backend.capture(freq, gain, n)
    return analyze_block_bytes(raw, nfft=4096, device=device)


def calibrate_frequency(
    backend: CaptureBackend,
    freq_hz: float,
    config: CalibrationConfig = CalibrationConfig(),
    verbose: bool = False,
    device: Optional[torch.device] = None,
) -> CalibrationResult:
    """Binary-search the gain into the target SNR band
    (gain_calibrator.go:90-176 decision logic: clipping/overload → lower
    half; SNR below band → upper half; inside band → done). Each test
    capture is analyzed on ``device`` (default: the card, an error
    without one)."""
    dev = default_device() if device is None else torch.device(device)
    lo, hi = config.min_gain_db, config.max_gain_db
    history: List[Tuple[float, float]] = []
    clean: List[bool] = []  # per-iteration: free of clipping/overload
    for it in range(config.max_iterations):
        gain = 0.5 * (lo + hi)
        stats = _measure(backend, freq_hz, gain, config.test_samples, dev)
        snr = stats.snr_db
        history.append((gain, snr))
        clean.append(not (stats.is_clipping or stats.is_overloaded))
        if verbose:
            print(
                f"  iter {it+1}: gain {gain:.1f} dB → SNR {snr:.1f} dB"
                f"{' CLIP' if stats.is_clipping else ''}"
                f"{' OVL' if stats.is_overloaded else ''}"
            )
        if stats.is_clipping or stats.is_overloaded or snr > config.target_snr_hi_db:
            hi = gain
            continue
        if snr < config.target_snr_lo_db:
            lo = gain
            continue
        # In band — done.
        return CalibrationResult(
            freq_hz=freq_hz,
            gain_db=gain,
            snr_db=snr,
            converged=True,
            iterations=it + 1,
            history=history,
        )
    # Not converged: report the best in-range-ish attempt — highest SNR
    # among iterations that were actually free of clipping/overload,
    # mirroring the reference's fallback printout. (A clipped capture can
    # report an in-band SNR; recommending its gain would be wrong.)
    usable = [
        (g, s) for (g, s), ok in zip(history, clean)
        if ok and s <= config.target_snr_hi_db
    ]
    gain, snr = max(usable or history, key=lambda t: t[1])
    return CalibrationResult(
        freq_hz=freq_hz,
        gain_db=gain,
        snr_db=snr,
        converged=False,
        iterations=config.max_iterations,
        history=history,
    )


def calibrate(
    backend: CaptureBackend,
    ref_freq_hz: float,
    tgt_freq_hz: float,
    config: CalibrationConfig = CalibrationConfig(),
    verbose: bool = False,
    device: Optional[torch.device] = None,
) -> Tuple[CalibrationResult, CalibrationResult]:
    """Calibrate both frequencies (the reference calibrates ref then
    target, each with freq+100 kHz as the dummy second frequency,
    gain_calibrator.go:199-210) on ``device`` (default: the card)."""
    dev = default_device() if device is None else torch.device(device)
    ref = calibrate_frequency(backend, ref_freq_hz, config, verbose, dev)
    tgt = calibrate_frequency(backend, tgt_freq_hz, config, verbose, dev)
    return ref, tgt
