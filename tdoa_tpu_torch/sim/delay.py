"""Physically-true propagation delays for simulation.

Torch port of ``tdoa_tpu.sim.delay``. The reference's simulators encode
TDOA only as a carrier-phase offset (simulator.go:111-117,
weak_signal_simulator.go:162-169) — the envelope is never actually
shifted. Here a delay shifts the *complex envelope* by the exact
fractional number of samples (frequency-domain phase ramp) **and**
rotates the carrier phase (``exp(-j2πf_c τ)``), which is what a real
down-converted capture of a delayed RF signal looks like.

Signals are ``complex64`` ``[..., n]``. A delay may be a scalar or one
per row (``[k]`` against a signal ``[n]`` gives ``[k, n]``: one
transform of the signal, one delayed copy per receiver). Angles are
float32 products in the reference's order, so the two packages round
them alike; the FFT runs at the signal's own length (a power-of-two pad
would change the circular wrap).
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _unit(ang: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(ang), ang)


def fractional_delay(x: torch.Tensor, delay_samples) -> torch.Tensor:
    """Circularly delay a complex signal by a (possibly fractional) number
    of samples via an FFT phase ramp. Positive delay shifts the signal
    later. Exact for bandlimited signals; circular wrap is negligible when
    |delay| ≪ len(x)."""
    n = int(x.shape[-1])
    d = _f32(delay_samples, x.device)
    f = torch.fft.fftfreq(n, device=x.device)  # cycles/sample, f32
    ramp = _unit((float(np.float32(-2.0 * np.pi)) * f) * d[..., None])
    return torch.fft.ifft(torch.fft.fft(x, dim=-1) * ramp, dim=-1)


def apply_channel(
    x: torch.Tensor,
    delay_samples,
    carrier_freq_hz: float,
    sample_rate: float,
    amplitude=1.0,
) -> torch.Tensor:
    """Delay + carrier rotation + path amplitude: the point-source channel.

    ``x`` is the transmitted complex envelope; the received envelope is
    ``amplitude · x(t − τ) · exp(−j2π f_c τ)`` with ``τ`` in samples.
    """
    d = _f32(delay_samples, x.device)
    tau_s = d / sample_rate
    phase = _unit(float(np.float32(-2.0 * np.pi * carrier_freq_hz)) * tau_s)
    gain = _f32(amplitude, x.device) * phase
    return gain[..., None] * fractional_delay(x, d)


def apply_channel_moving(
    x: torch.Tensor,
    delay_mid_samples,
    delay_rate,  # dτ/dt, dimensionless (samples per sample)
    carrier_freq_hz: float,
    sample_rate: float,
    amplitude=1.0,
) -> torch.Tensor:
    """Point-source channel with a linearly drifting delay (moving
    emitter or receiver): τ(t) = τ_mid + α·(t − t_mid).

    The carrier term exp(−j2π f_c τ(t)) is applied exactly — its linear
    part IS the Doppler shift ν = −f_c·α that the CAF measures. The
    envelope is delayed at the block-midpoint value only: the neglected
    envelope drift is α·L/2 samples over a block (≈0.04 samples for
    150 m/s over 2^18 samples at 2 Msps) — far below the envelope
    correlation resolution, while the carrier Doppler it produces is
    exactly what matters.
    """
    n = int(x.shape[-1])
    base = apply_channel(x, delay_mid_samples, carrier_freq_hz, sample_rate,
                         amplitude)
    t_rel = (torch.arange(n, dtype=torch.float32, device=x.device)
             - (n - 1) / 2.0) / sample_rate  # seconds from mid
    b = float(np.float32(-2.0 * np.pi * carrier_freq_hz))
    rate = _f32(delay_rate, x.device)
    return base * _unit((b * rate)[..., None] * t_rel)
