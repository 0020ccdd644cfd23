"""Transmitted-signal models: FM stations, tones, bandlimited noise.

Torch port of ``tdoa_tpu.sim.source``. The reference transmits pure
carrier tones (generatePerfectSignal, simulator.go:67-82). A tone has no
envelope structure, so envelope cross-correlation of tones is
delay-blind — these sources carry real modulation (FM-of-noise audio, as
an actual NOAA/broadcast signal does) so the correlator is genuinely
exercised.

Random draws come from a ``torch.Generator`` on the device that runs the
simulation (JAX's counter-based streams cannot be reproduced in torch),
and each draw is kept apart from the deterministic shaping after it:
``brickwall`` shapes ``bandlimited_noise``'s draw, ``fm_phase`` turns an
audio program into the FM envelope. Complex signals are ``complex64``.
"""

from __future__ import annotations

import numpy as np
import torch

from tdoa_tpu_torch.dsp.fm import fm_modulate


def brickwall(x: torch.Tensor, bandwidth_hz: float,
              sample_rate: float) -> torch.Tensor:
    """Brick-wall filter real ``x`` [n] to ±``bandwidth_hz`` and scale it
    to unit RMS: the shaping of ``bandlimited_noise``'s draw."""
    n = int(x.shape[-1])
    spec = torch.fft.rfft(x.to(torch.float32))
    f = torch.fft.rfftfreq(n, d=1.0 / sample_rate, device=x.device)
    spec = torch.where(f <= bandwidth_hz, spec, torch.zeros_like(spec))
    y = torch.fft.irfft(spec, n=n)
    return y / (y.std(correction=0) + 1e-12)


def bandlimited_noise(n: int, bandwidth_hz: float, sample_rate: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Real white noise brick-wall filtered to ±bandwidth, unit RMS, on
    the generator's device."""
    x = torch.randn(n, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return brickwall(x, bandwidth_hz, sample_rate)


def fm_phase(audio: torch.Tensor, sample_rate: float,
             deviation_hz: float) -> torch.Tensor:
    """The unit-amplitude complex FM envelope of an audio program at
    ``sample_rate`` (``dsp.fm.fm_modulate``, as complex64)."""
    p = fm_modulate(audio, sample_rate, deviation_hz)
    return torch.complex(p[0], p[1])


def fm_source(
    n: int,
    sample_rate: float,
    generator: torch.Generator,
    audio_bandwidth_hz: float = 5_000.0,
    deviation_hz: float = 25_000.0,
) -> torch.Tensor:
    """FM-modulated complex envelope: audio-bandlimited noise frequency-
    modulated at the given deviation (NBFM defaults ≈ NOAA weather radio,
    the reference's REF signal at 162.4 MHz). Unit amplitude."""
    audio = bandlimited_noise(n, audio_bandwidth_hz, sample_rate, generator)
    return fm_phase(audio, sample_rate, deviation_hz)


def tone_source(n: int, freq_hz: float, sample_rate: float,
                device=None) -> torch.Tensor:
    """Pure complex tone (the reference simulator's model, for parity),
    on ``device`` (default: the card)."""
    from tdoa_tpu_torch.utils.platform import default_device

    dev = default_device() if device is None else torch.device(device)
    t = torch.arange(n, dtype=torch.float32, device=dev) / sample_rate
    ang = float(np.float32(2.0 * np.pi * freq_hz)) * t
    return torch.polar(torch.ones_like(ang), ang)
