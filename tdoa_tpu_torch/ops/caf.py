"""Cross Ambiguity Function: joint delay-Doppler estimation.

Torch port of ``tdoa_tpu.ops.caf``. Long coherent integrations
decorrelate when the emitter (or a receiver clock) moves: a relative
frequency offset ν rotates the segment-to-segment cross-spectrum phase,
and the plain sum (ops/corr.py) washes out. The CAF searches (τ, ν)
jointly.

Segment cross-spectra are kept per segment instead of summed, so Doppler
compensation becomes a phase ramp over the *segment index* — one complex
matrix product against a steering matrix turns S per-segment spectra
into D Doppler-compensated coherent sums, reusing every FFT:

    caf[d, f] = Σ_s cross[s, f] · exp(−j2π ν_d s T_seg)

Validity: within-segment rotation must be small (|ν|·T_seg ≲ 0.1), so
the unambiguous Doppler span is ±1/(2·T_seg).

Signals are planar ``[2, n_st, N]`` real tensors, spectra native
``complex64``. The steering products run in full float32 whatever the
process's TF32 setting (``_ieee_matmul``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from tdoa_tpu_torch.ops.corr import (
    SEG_CHUNK_BYTES,
    _lag_window,
    _phase_slope_refine,
    resolve_seg,
)
from tdoa_tpu_torch.ops.peaks import parabolic_peak


class CafResult(NamedTuple):
    delay: torch.Tensor  # [m] samples (sub-sample, at the best Doppler)
    doppler_hz: torch.Tensor  # [m] best Doppler bin (sub-bin refined)
    peak_value: torch.Tensor  # [m]
    surface: torch.Tensor  # [m, n_doppler, 2*max_lag+1] |CAF| map


@contextlib.contextmanager
def _ieee_matmul():
    """Full-float32 matrix products inside the block (cuBLAS would
    otherwise round the operands to TF32 when the process allows it)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _segment_cross_spectra(x: torch.Tensor, pair_idx, seg_len: int,
                           fft_len: int):
    """Per-segment cross spectra of planar ``x`` [2, n_st, N], kept
    unsummed: (complex64 [m, S, F], S). Segments are transformed in
    chunks of at most ``SEG_CHUNK_BYTES``."""
    from tdoa_tpu_torch.ops.kernels.corr_accum import device_pairs

    n_st, n = int(x.shape[1]), int(x.shape[2])
    n_seg = n // seg_len
    p = device_pairs(pair_idx, x.device).long()
    ii, jj = p[:, 0], p[:, 1]
    m = int(p.shape[0])
    cross = torch.empty(m, n_seg, fft_len, dtype=torch.complex64,
                        device=x.device)
    chunk = max(1, SEG_CHUNK_BYTES // ((n_st + m) * fft_len * 8))
    for s0 in range(0, n_seg, chunk):
        s1 = min(s0 + chunk, n_seg)
        seg = x[:, :, s0 * seg_len:s1 * seg_len].to(torch.float32)
        z = torch.complex(seg[0], seg[1]).reshape(n_st, s1 - s0, seg_len)
        spec = torch.fft.fft(z, n=fft_len, dim=-1)  # [n_st, S, F]
        cross[:, s0:s1] = spec[jj] * spec[ii].conj()
    return cross, n_seg


def caf_pairs(
    x: torch.Tensor,  # planar [2, n_st, N]
    pair_idx,  # [m, 2]
    sample_rate: float,
    max_lag: int = 1024,
    seg_len: int = 1 << 15,
    n_doppler: int = 32,
    doppler_span_hz: Optional[float] = None,
    eps: float = 1e-3,
    weighting: str = "phat",
) -> CafResult:
    """Delay-Doppler surface for every station pair.

    ``doppler_span_hz`` defaults to the full unambiguous span
    ±1/(2·T_seg). Doppler sign convention: positive ν means station
    ``j``'s signal is received *up-shifted* relative to station ``i``'s.

    ``weighting="phat"`` whitens per segment (sharp delay peaks for
    pairwise station×station surfaces, both sides noisy).
    ``weighting="none"`` keeps the raw cross-power — the true matched
    filter, correct when one side is a NOISELESS template: whitening
    there hands the empty bins' segment-edge leakage — common to every
    channel and anchored at lag 0 — enough votes to bury near-zero true
    delays.
    """
    if weighting not in ("phat", "none"):
        raise ValueError(f"caf weighting must be 'phat' or 'none', "
                         f"got {weighting!r}")
    n = int(x.shape[-1])
    seg_len_r, fft_len = resolve_seg(n, max_lag, seg_len, None)
    t_seg = seg_len_r / sample_rate
    if doppler_span_hz is None:
        doppler_span_hz = 1.0 / (2.0 * t_seg)
    dev = x.device
    nu = torch.linspace(-doppler_span_hz, doppler_span_hz, n_doppler,
                        dtype=torch.float32, device=dev)

    cross, n_seg = _segment_cross_spectra(x, pair_idx, seg_len_r, fft_len)

    # PHAT whitening per segment (flat spectrum ⇒ sharp delay peak),
    # then an energy weight per segment: plain per-segment whitening
    # would hand noise-only segments (emitter silent) the same unit vote
    # as high-SNR ones in the slow-time Doppler sum, while whitening by
    # the segment-averaged magnitude blunts/biases the delay peak.
    if weighting == "phat":
        mag = cross.abs()
        seg_mag = mag.mean(-1, keepdim=True)  # [m, S, 1]
        d = mag + eps * seg_mag + 1e-30
        seg_w = seg_mag / (seg_mag.mean(1, keepdim=True) + 1e-30)
        white = cross / d * seg_w
        del mag, d
    else:
        # Plain cross-power: bins vote by energy (segments implicitly
        # too), the matched-filter weighting.
        white = cross

    # Slow-time steering: a pair with relative Doppler ν has cross-
    # spectrum phase advancing by +2π ν T_seg per segment (positive ν =
    # station j up-shifted); steer[d, s] = exp(−j2π ν_d s T_seg)
    # derotates it so the sum is coherent at ν_d = ν.
    s_idx = torch.arange(n_seg, dtype=torch.float32, device=dev)
    theta = -2.0 * np.pi * nu[:, None] * s_idx[None, :] * t_seg
    steer = torch.polar(torch.ones_like(theta), theta)  # [D, S]

    with _ieee_matmul():
        # caf[m, D, F] = Σ_s steer[D, s] · white[m, s, F]
        caf_spec = torch.matmul(steer, white)
        del white
        r = torch.fft.ifft(caf_spec, dim=-1)  # correlation per Doppler bin
        win = _lag_window(r, max_lag).abs()  # [m, D, W]
        del caf_spec, r

        m, ndop, w = win.shape
        idx = torch.argmax(win.reshape(m, ndop * w), dim=-1)
        di = idx // w
        # Parabolic refinement in both axes around the joint peak.
        rows = torch.arange(m, device=dev)
        lag_pos, peak = parabolic_peak(win[rows, di])
        delay = lag_pos - float(max_lag)
        # Sub-sample refinement on the Doppler-compensated coherent
        # spectrum at the winning bin — built from the *unwhitened*
        # cross-spectra so the |C|² weighting in the phase-slope fit
        # favors coherent in-band bins (whitened bins would vote
        # uniformly, noise included).
        best = torch.matmul(steer[di][:, None, :], cross)[:, 0]  # [m, F]
    delay, _, _ = _phase_slope_refine(best, torch.round(delay), fft_len,
                                      max_lag)
    dop_pos, _ = parabolic_peak(win[rows, :, idx % w])
    dop_step = (2.0 * doppler_span_hz) / (n_doppler - 1)
    doppler = -doppler_span_hz + dop_pos * dop_step
    return CafResult(delay=delay, doppler_hz=doppler, peak_value=peak,
                     surface=win)
