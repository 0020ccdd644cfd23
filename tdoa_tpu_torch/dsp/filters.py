"""FIR filtering, decimation, DC removal.

Torch port of ``tdoa_tpu.dsp.filters``. Filters are windowed-sinc FIRs
designed on the host (numpy, copied from the reference) and applied to
tensors along the last axis. A planar complex signal ``[2, ..., N]``
filters each component, so every function here takes real signals and
planar ones alike.

The FIR is a loop over the taps of strided slices, not ``conv1d``: a
float32 convolution on the card goes through cuDNN in TF32 by default,
which keeps about three decimal digits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tdoa_tpu_torch.dsp.windows import hann


def remove_dc(x: torch.Tensor) -> torch.Tensor:
    """Subtract the mean along the last axis."""
    return x - x.mean(-1, keepdim=True)


@functools.lru_cache(maxsize=None)
def lowpass_taps(cutoff_hz: float, fs: float, num_taps: int = 129) -> np.ndarray:
    """Hann-windowed sinc lowpass, unity DC gain. ``num_taps`` odd."""
    if num_taps % 2 == 0:
        num_taps += 1
    fc = cutoff_hz / fs  # normalized (cycles/sample)
    k = np.arange(num_taps) - (num_taps - 1) / 2
    h = 2 * fc * np.sinc(2 * fc * k)
    h *= hann(num_taps)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def bandpass_taps(
    lo_hz: float, hi_hz: float, fs: float, num_taps: int = 257
) -> np.ndarray:
    """Bandpass as difference of two lowpasses (linear phase preserved)."""
    return (
        lowpass_taps(hi_hz, fs, num_taps) - lowpass_taps(lo_hz, fs, num_taps)
    ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def hilbert_taps(num_taps: int = 63) -> np.ndarray:
    """Hann-windowed FIR Hilbert transformer (−j·sgn(f) response), for the
    phasing-method SSB demodulator. ``num_taps`` odd; zero group delay
    relative to the unfiltered channel under 'SAME' filtering.

    Signs are pre-flipped for ``fir_filter``'s cross-correlation (the taps
    are not reversed), so ``fir_filter(sin, hilbert_taps())≈−cos``.
    """
    if num_taps % 2 == 0:
        num_taps += 1
    k = np.arange(num_taps) - (num_taps - 1) / 2
    h = np.where(k % 2 != 0, -2.0 / (np.pi * np.where(k == 0, 1.0, k)), 0.0)
    return (h * hann(num_taps)).astype(np.float32)


def _conv1d(x: torch.Tensor, taps: np.ndarray, stride: int) -> torch.Tensor:
    """'SAME' 1-D cross-correlation along the last axis with a stride, as
    XLA pads it: ``ceil(n/stride)`` outputs, a padding total of
    ``max((out−1)·stride + k − n, 0)`` with ``total // 2`` on the left."""
    n, k = int(x.shape[-1]), len(taps)
    n_out = -(-n // stride)
    total = max((n_out - 1) * stride + k - n, 0)
    xp = F.pad(x, (total // 2, total - total // 2))
    span = (n_out - 1) * stride + 1
    y = torch.zeros(*x.shape[:-1], n_out, dtype=torch.float32, device=x.device)
    for t, h in enumerate(taps.tolist()):
        y += h * xp[..., t:t + span:stride]
    return y


def fir_filter(x: torch.Tensor, taps: np.ndarray, stride: int = 1) -> torch.Tensor:
    """Apply a real-tap FIR along the last axis; ``stride`` > 1 decimates
    in the same pass. A planar complex ``[2, ..., N]`` filters each
    component."""
    return _conv1d(x.to(torch.float32), np.asarray(taps, np.float32), stride)


def fir_decimate(
    x: torch.Tensor,
    decim: int,
    fs: float,
    cutoff_frac: float = 0.45,
    num_taps: int = 129,
) -> torch.Tensor:
    """Anti-aliased decimation by ``decim`` (cutoff at ``cutoff_frac`` of
    the output Nyquist) in one strided pass."""
    taps = lowpass_taps(cutoff_frac * fs / decim, fs, num_taps)
    return fir_filter(x, taps, stride=decim)


def resample_fft(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Resample a real signal to ``n_out`` samples by Fourier zero-pad /
    truncation (exact for bandlimited inputs). Sample k of the output
    sits at time ``k·n_in/n_out`` of the input (both grids share t=0)."""
    x = x.to(torch.float32)
    n_in = int(x.shape[-1])
    if n_out == n_in:
        return x
    spec = torch.fft.rfft(x, dim=-1)
    k_in, k_out = n_in // 2 + 1, n_out // 2 + 1
    if n_out > n_in:
        spec = F.pad(spec, (0, k_out - k_in))
        # Upsampling splits an even input's Nyquist bin across the two
        # conjugate bins it unfolds into.
        if n_in % 2 == 0:
            spec[..., k_in - 1] *= 0.5
    else:
        spec = spec[..., :k_out].clone()
        if n_out % 2 == 0:
            # The output Nyquist bin must be real for a real irfft.
            spec[..., -1] = spec[..., -1].real.to(spec.dtype)
    return torch.fft.irfft(spec, n=n_out, dim=-1) * (n_out / n_in)
