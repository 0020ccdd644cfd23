"""Spectral SNR estimation — analyzer.go's percentile-split semantics on a
proper Welch PSD (torch port of ``tdoa_tpu.dsp.snr``).

The reference computes an O(N²) DFT (analyzer.go:322-337) over ≤16384
samples with a Blackman-Harris window, then calls the mean of the top-10%
bins "signal" and the bottom-50% "noise" (analyzer.go:239-265; the fast
analyzer uses bottom-40%, fast_analyzer.go:203-204). Those percentile
semantics are kept (they define the calibrator's feedback signal); the
PSD is a Welch average of windowed segments through ``torch.fft``, on
the device that holds the signal.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tdoa_tpu_torch.dsp.windows import blackman_harris, hann

_WINDOWS = {"hann": hann, "blackman_harris": blackman_harris}


def psd_welch(x: torch.Tensor, nfft: int = 8192,
              window: str = "blackman_harris") -> torch.Tensor:
    """Welch-averaged power spectral density of complex ``x`` [..., N]
    over the last axis, on ``x``'s device.

    Splits into ⌊N/nfft⌋ segments, windows, transforms, averages |X|².
    Returns float32 [..., nfft] (two-sided, fftshift NOT applied). A
    capture shorter than ``nfft`` shrinks it to the largest power of two
    that fits."""
    n = int(x.shape[-1])
    if n < nfft:
        nfft = 1 << (n.bit_length() - 1)
    n_seg = max(n // nfft, 1)
    use = n_seg * nfft
    w = torch.from_numpy(_WINDOWS[window](nfft)).to(x.device)
    segs = x[..., :use].reshape(*x.shape[:-1], n_seg, nfft) * w
    spec = torch.fft.fft(segs)
    abs2 = spec.real.square() + spec.imag.square()
    return abs2.mean(dim=-2) / (w.square().sum() * nfft)


def spectral_snr(
    x: torch.Tensor,
    nfft: int = 8192,
    window: str = "blackman_harris",
    top_frac: float = 0.10,
    bottom_frac: float = 0.50,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SNR via the analyzer's percentile split: mean(top ``top_frac`` bins)
    over mean(bottom ``bottom_frac`` bins), in dB.

    Returns (snr_db, signal_power, noise_power), each [...]-shaped, on
    ``x``'s device."""
    psd = psd_welch(x, nfft=nfft, window=window)
    s = torch.sort(psd, dim=-1).values
    n_bins = int(psd.shape[-1])
    k_top = max(int(n_bins * top_frac), 1)
    k_bot = max(int(n_bins * bottom_frac), 1)
    sig = s[..., n_bins - k_top:].mean(dim=-1)
    noise = s[..., :k_bot].mean(dim=-1)
    snr_db = 10.0 * torch.log10(torch.clamp(sig, min=1e-30)
                                / torch.clamp(noise, min=1e-30))
    return snr_db, sig, noise
