"""FM quadrature demodulation + decimation, and the AM/SSB demodulators.

Torch port of ``tdoa_tpu.dsp.fm``. Complex baseband signals are planar
``[2, ..., N]`` tensors (row 0 = I, row 1 = Q), the layout of the port's
capture blocks; audio is real ``[..., N]``.

- the discriminator is the pairwise-product form: phase increments come
  from ``x[n]·conj(x[n−1])``, so there is no running state to unwrap;
- decimation is a strided windowed-sinc FIR (``dsp/filters.py``).

``fm_demodulate`` is the reference's XLA route (129 SAME taps, DC removed
before the FIR). The processor's FM mode runs kernel 3
(``ops/kernels/fm_demod.py``: causal 128 taps, DC left to the caller)
on every device instead, as the reference does on its TPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tdoa_tpu_torch.dsp.filters import fir_decimate, fir_filter, hilbert_taps, remove_dc


# Row width of ``running_sum``'s blocked scan.
_SCAN_ROW = 4096


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Running sum of f32 ``x`` [..., N] along the last axis, the same
    bit for bit on every run. ``torch.cumsum`` of one long CUDA row is a
    single-pass scan whose float association changes from run to run.
    Here rows of ``_SCAN_ROW`` samples are
    scanned independently, in a fixed order, and the running sum of the
    row totals, in float64 on the host, offsets them."""
    x = x.to(torch.float32)
    n = int(x.shape[-1])
    rows = torch.nn.functional.pad(x, (0, (-n) % _SCAN_ROW)).unflatten(
        -1, (-1, _SCAN_ROW))
    inner = torch.cumsum(rows, dim=-1)
    totals = inner[..., -1].to(torch.float64).cpu()
    offsets = (torch.cumsum(totals, dim=-1) - totals).to(x.device)
    out = inner.to(torch.float64) + offsets[..., None]
    return out.flatten(-2)[..., :n].to(torch.float32)


def fm_modulate(
    audio: torch.Tensor,
    sample_rate: float,
    deviation_hz: float = 25_000.0,
) -> torch.Tensor:
    """The unit-amplitude planar baseband FM signal ``[2, ..., N]`` an
    audio program generates: ``f_inst = k_f·audio`` around the carrier.
    ``audio`` must already be at ``sample_rate``; full scale ±1 maps to
    ±``deviation_hz``. Phase integrates from 0 at sample 0
    (``running_sum``: the same on every run)."""
    phase = (2.0 * np.pi * deviation_hz / sample_rate) * running_sum(audio)
    return torch.stack([torch.cos(phase), torch.sin(phase)])


def fm_discriminate(x: torch.Tensor, sample_rate: float = 1.0) -> torch.Tensor:
    """Instantaneous frequency in Hz (per-sample phase increment) of
    planar ``x`` ``[2, ..., N]``: ``d[n] = angle(x[n]·conj(x[n−1]))·fs/2π``;
    d[0] = 0. Returns ``[..., N]``."""
    re, im = x[0].to(torch.float32), x[1].to(torch.float32)
    p_re = re[..., 1:] * re[..., :-1] + im[..., 1:] * im[..., :-1]
    p_im = im[..., 1:] * re[..., :-1] - re[..., 1:] * im[..., :-1]
    inc = torch.nn.functional.pad(torch.atan2(p_im, p_re), (1, 0))
    return inc * float(np.float32(sample_rate / (2.0 * np.pi)))


def fm_demodulate(
    x: torch.Tensor,
    sample_rate: float,
    decim: int = 16,
    deviation_hz: Optional[float] = None,
    num_taps: int = 129,
) -> torch.Tensor:
    """Full demod chain: discriminator → DC removal → anti-aliased
    decimation. Returns real audio at ``sample_rate/decim``. DC removal
    strips the receiver LO frequency offset; ``deviation_hz`` normalizes
    audio to ≈±1 full scale."""
    d = remove_dc(fm_discriminate(x, sample_rate))
    if deviation_hz:
        d = d / float(np.float32(deviation_hz))
    if decim > 1:
        d = fir_decimate(d, decim, sample_rate, num_taps=num_taps)
    return d


def am_demodulate(
    x: torch.Tensor,
    sample_rate: float,
    decim: int = 16,
    num_taps: int = 129,
) -> torch.Tensor:
    """Envelope (AM) demodulation of planar ``x``: anti-aliased complex
    decimation, then magnitude, then DC removal (strips the carrier
    level)."""
    if decim > 1:
        x = fir_decimate(x, decim, sample_rate, num_taps=num_taps)
    env = torch.sqrt(x[0] * x[0] + x[1] * x[1])
    return remove_dc(env)


def _hilbert_len(fs_audio: float, transition_hz: float) -> int:
    """Hilbert FIR length whose transition band (≈4·fs/T for the Hann
    window) is ``transition_hz``, clamped odd in [255, 4095]."""
    n = int(4.0 * fs_audio / transition_hz)
    n = max(255, min(4095, n))
    return n | 1


def ssb_demodulate(
    x: torch.Tensor,
    sample_rate: float,
    sideband: str = "usb",
    decim: int = 16,
    num_taps: int = 129,
    hilbert_transition_hz: float = 150.0,
) -> torch.Tensor:
    """Single-sideband demodulation of planar ``x`` by the phasing
    method: USB audio is ``(I − H{Q})/2``, LSB ``(I + H{Q})/2`` with a
    Hilbert FIR H. Decimation runs first so the Hilbert FIR operates at
    the audio rate; its length scales with that rate."""
    if sideband not in ("usb", "lsb"):
        raise ValueError(f"sideband must be 'usb' or 'lsb', got {sideband!r}")
    if decim > 1:
        x = fir_decimate(x, decim, sample_rate, num_taps=num_taps)
    hq = fir_filter(
        x[1], hilbert_taps(_hilbert_len(sample_rate / decim,
                                        hilbert_transition_hz))
    )
    audio = (x[0] - hq if sideband == "usb" else x[0] + hq) * 0.5
    return remove_dc(audio)
