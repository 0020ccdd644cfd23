"""GCC cross-correlation — the hot path.

Torch port of ``tdoa_tpu.ops.corr``:

- ``correlate_pairs_fused``: the fixed kernel geometry (kernel 1
  accumulates the K split banks, ``ops/kernels/corr_accum.py``);
- ``correlate_pairs_planar``: the segmented correlator of any segment
  and FFT length (``resolve_seg``), with ``torch.fft`` over chunks of
  segments — blocks shorter than one kernel segment, lags beyond its
  alias-free window, ``accumulator="xla"`` and the FM mode's audio;
- ``_combine_splits`` (the full capture's finish plus the split-σ probe,
  kernel 2 for HT/ML weighting, ``ops/kernels/zoom_probe.py``),
  ``_finish_correlation`` (GCC weighting, iFFT, parabolic peak,
  phase-slope refine, σ model) and ``clock_correct_blocks``, shared by
  both.

Signals are planar ``[2, n_st, N]`` real tensors, spectra native
``complex64`` tensors. Sign convention: for pair ``(i, j)`` the
cross-spectrum is ``X_j · conj(X_i)``, so a positive delay means the
signal reaches station *j* later than station *i*. With FFT length ≥
seg_len + max_lag the circular correlation equals the linear one for
all |lag| ≤ max_lag.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tdoa_tpu_torch.ops.peaks import parabolic_peak, peak_quality
from tdoa_tpu_torch.utils.constants import DEFAULT_MAX_LAG

TWO_PI = 2.0 * np.pi
# Bound on one chunk of the segmented correlator's spectra (stations and
# pair products): the reference scans segment by segment in constant
# memory; the port transforms segments in chunks of at most this size.
SEG_CHUNK_BYTES = 256 << 20


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def correlation_lags(max_lag: int) -> np.ndarray:
    """Lag axis for the correlation window: [-max_lag, ..., +max_lag]."""
    return np.arange(-max_lag, max_lag + 1)


class CorrResult(NamedTuple):
    delay: torch.Tensor  # [m] sub-sample delay estimate (samples)
    peak_value: torch.Tensor  # [m] normalized peak magnitude
    quality: torch.Tensor  # [m] peak-to-sidelobe ratio
    corr: torch.Tensor  # [m, 2*max_lag+1] normalized |correlation| window
    delay_std: torch.Tensor  # [m] 1σ delay standard error (samples)
    corr_c: Optional[torch.Tensor] = None  # [m, W] complex window


def _fftfreq(n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.fft.fftfreq(n).astype(np.float32)).to(device)


def _pair_index(pair_idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(pair_idx, np.int64).reshape(-1, 2),
                           device=device)


def _weight_factor(cross: torch.Tensor, psd: torch.Tensor, pair_idx,
                   weighting: str, eps: float, n_seg=None) -> torch.Tensor:
    """The real per-bin GCC weighting multiplier s [m, F] such that the
    weighted spectrum is ``cross ⊙ s`` (1 for weighting="none")."""
    mag = cross.abs()
    if weighting == "none":
        return torch.ones_like(mag)
    p = _pair_index(pair_idx, cross.device)
    if weighting == "phat":
        return 1.0 / (mag + eps * mag.mean(-1, keepdim=True) + 1e-30)
    if weighting == "scot":
        denom = torch.sqrt(torch.clamp(psd[p[:, 0]] * psd[p[:, 1]], min=0.0))
        return 1.0 / (denom + eps * denom.mean(-1, keepdim=True) + 1e-30)
    if weighting in ("ht", "ml"):
        # Hannan–Thomson: PHAT phase times the SNR weight |γ|²/(1−|γ|²)
        # of the segment-averaged coherence (clamped against powers that
        # round slightly negative), Welch-debiased by the segment count.
        saa = torch.clamp(psd[p[:, 0]], min=0.0)
        sbb = torch.clamp(psd[p[:, 1]], min=0.0)
        denom = torch.sqrt(saa) * torch.sqrt(sbb)
        gamma = mag / torch.clamp(denom, min=1e-30)
        gamma2 = torch.clamp(gamma * gamma, 0.0, 0.98)
        if n_seg is not None:
            s = torch.as_tensor(n_seg, dtype=torch.float32, device=cross.device)
            bias = torch.where(s > 1.0, 1.0 / torch.clamp(s, min=1.0),
                               torch.zeros_like(s))
            gamma2 = torch.clamp(
                (gamma2 - bias) / torch.clamp(1.0 - bias, min=1e-6), 0.0, 0.98)
        snr_w = gamma2 / (1.0 - gamma2)
        # A (near-)zero-power bin carries no information: zero its weight.
        floor = 1e-9 * denom.mean(-1, keepdim=True)
        snr_w = torch.where(denom > floor, snr_w, torch.zeros_like(snr_w))
        d = mag + eps * mag.mean(-1, keepdim=True) + 1e-30
        w = snr_w / torch.clamp(snr_w.amax(-1, keepdim=True), min=1e-30)
        return w / d
    raise ValueError(f"unknown GCC weighting: {weighting!r}")


def _weight_spectrum(cross, psd, pair_idx, weighting: str, eps: float,
                     n_seg=None) -> torch.Tensor:
    if weighting == "none":
        return cross
    return cross * _weight_factor(cross, psd, pair_idx, weighting, eps, n_seg)


def _lag_window(r: torch.Tensor, max_lag: int) -> torch.Tensor:
    """Reorder the circular correlation to lags [-max_lag, ..., +max_lag]."""
    if max_lag == 0:
        return r[..., :1]
    return torch.cat([r[..., -max_lag:], r[..., :max_lag + 1]], dim=-1)


def _int_deramp(coarse: torch.Tensor, fft_len: int) -> torch.Tensor:
    """2π·(k·d mod F)/F for integer delays d: exact integer residue
    (int64 products — the same residue the reference's int32 form
    computes wherever its overflow guard admits it)."""
    k = torch.arange(fft_len, dtype=torch.int64, device=coarse.device)
    d = torch.round(coarse).to(torch.int64)
    frac = (k[None, :] * d[:, None]) % fft_len
    return frac.to(torch.float32) * (TWO_PI / fft_len)


def _phase_slope_refine(cross: torch.Tensor, coarse_delay: torch.Tensor,
                        fft_len: int, max_lag: int,
                        peak_phase: Optional[torch.Tensor] = None,
                        clip_samples: float = 1.0):
    """Refine a coarse delay by weighted LS on the cross-spectrum phase:
    deramp by the coarse estimate, re-center by the carrier-phase
    intercept ``peak_phase`` (the complex window's phase at the peak
    lag; without it, the |C|²-weighted mean phasor of the derampled
    spectrum, wrap-free by construction), fit φ ≈ θ − 2πfδ with |C|²
    weights. Returns (delay, delay_std, peak_width)."""
    f = _fftfreq(fft_len, cross.device)[None, :]
    # The fit does not change with the weights' scale. |C| scaled by a
    # power of two (exact: every sum keeps its bits) to a peak in
    # [0.5, 1) keeps the fit's fourth-power sums (det, n_eff) inside
    # float32, where |C|² grows with the square of the segment count: a
    # strong signal over a 100 s block's 1479 segments overflowed them,
    # and every delay was NaN.
    peak = cross.abs().amax(-1, keepdim=True)
    s = torch.ldexp(torch.ones_like(peak), -torch.frexp(peak).exponent)
    w = (cross.real * s).square() + (cross.imag * s).square()
    two_pi = TWO_PI
    if 0 < max_lag and fft_len * (max_lag + 1) < 2**31:
        ramp = _int_deramp(coarse_delay, fft_len)
    else:
        ramp = two_pi * f * coarse_delay[:, None]
    if peak_phase is None:
        c = cross * torch.polar(torch.ones_like(ramp), ramp)
        peak_phase = torch.atan2((w * c.imag).sum(-1), (w * c.real).sum(-1))
    raw = torch.angle(cross) + ramp - peak_phase[:, None]
    phi = raw - two_pi * torch.round(raw / two_pi)
    sw = w.sum(-1)
    swf = (w * f).sum(-1)
    swff = (w * f * f).sum(-1)
    swp = (w * phi).sum(-1)
    swfp = (w * f * phi).sum(-1)
    det = sw * swff - swf * swf
    slope = (sw * swfp - swf * swp) / torch.clamp(det, min=1e-30)
    intercept = (swff * swp - swf * swfp) / torch.clamp(det, min=1e-30)
    delta = -slope / two_pi
    # ±1-sample clip: under multipath a looser bound lets the slope
    # drift off the direct-path peak the argmax selected.
    delta = torch.clamp(delta, -clip_samples, clip_samples)
    resid = phi - (intercept[:, None] - two_pi * f * delta[:, None])
    sw_safe = torch.clamp(sw, min=1e-30)
    sigma_r2 = (w * resid * resid).sum(-1) / sw_safe
    s_f = torch.clamp(swff / sw_safe - (swf / sw_safe) ** 2, min=1e-30)
    n_eff = sw_safe ** 2 / torch.clamp((w * w).sum(-1), min=1e-30)
    delay_std = torch.sqrt(sigma_r2 / (n_eff * s_f)) / two_pi
    peak_width = 1.0 / (two_pi * torch.sqrt(s_f))
    return coarse_delay + delta, delay_std, peak_width


def _finish_correlation(cross: torch.Tensor, psd: torch.Tensor,
                        energy: torch.Tensor, pair_idx, max_lag: int,
                        weighting: str, eps: float, fft_len: int,
                        refine: str, n_seg=None) -> CorrResult:
    """Accumulated cross-spectra → weighted correlation → refined peaks."""
    weighted = _weight_spectrum(cross, psd, pair_idx, weighting, eps, n_seg)
    r = torch.fft.ifft(weighted, dim=-1)  # [m, F] complex64
    win_c = _lag_window(r, max_lag)
    win = win_c.abs()
    if weighting == "none":
        # Normalize to a correlation coefficient: self-match → 1.
        p = _pair_index(pair_idx, cross.device)
        norm = torch.clamp(torch.sqrt(energy[p[:, 0]] * energy[p[:, 1]]),
                           min=1e-30)[:, None]
        win = win / norm
        win_c = win_c / norm
    pos, val = parabolic_peak(win)
    delay = pos - float(max_lag)
    if refine == "phase":
        coarse = torch.round(delay)
        # Carrier-phase intercept: the complex window's phase at the
        # peak lag.
        pos_i = torch.round(pos).to(torch.int64)
        peak_c = torch.gather(win_c, -1, pos_i[:, None])[:, 0]
        peak_phase = torch.angle(peak_c)
        delay, delay_std, peak_width = _phase_slope_refine(
            cross, coarse, fft_len, max_lag, peak_phase)
    else:
        delay_std = torch.zeros_like(delay)
        peak_width = None
    quality = peak_quality(win)
    if peak_width is not None:
        # Coarse-peak jitter W/q beyond the deramp's ±1-sample correction
        # range, in quadrature; capped at the search window's uniform std.
        sigma_coarse = peak_width / torch.clamp(quality, min=1.0)
        excess2 = torch.clamp(sigma_coarse * sigma_coarse - 1.0, min=0.0)
        cap = (2.0 * max_lag + 1.0) / np.sqrt(12.0)
        delay_std = torch.clamp(
            torch.sqrt(delay_std * delay_std + excess2), max=cap)
    return CorrResult(delay=delay, peak_value=val, quality=quality,
                      corr=win, delay_std=delay_std, corr_c=win_c)


def _zoom_corr_delay(wspec: torch.Tensor, coarse: torch.Tensor,
                     fft_len: int, max_lag: int,
                     half_width: int = 16) -> torch.Tensor:
    """Peak delay of a weighted cross-spectrum on a ±half_width lag
    window around ``coarse`` (per row) — a zoom DFT, the plain probe."""
    dev = wspec.device
    if 0 < max_lag and fft_len * (max_lag + 1) < 2**31:
        ang = _int_deramp(coarse, fft_len)
    else:
        ang = TWO_PI * _fftfreq(fft_len, dev)[None, :] * coarse[:, None]
    der = wspec * torch.polar(torch.ones_like(ang), ang)
    f = _fftfreq(fft_len, dev)
    delta = torch.arange(-half_width, half_width + 1, dtype=torch.float32,
                         device=dev)
    ang2 = TWO_PI * f[:, None] * delta[None, :]
    win = (der @ torch.polar(torch.ones_like(ang2), ang2)).abs()
    pos, _ = parabolic_peak(win)
    return coarse + (pos - float(half_width))


# Consistency factor for the K-group split σ, calibrated against truth
# (tdoa_tpu.ops.corr._SPLIT_STD_SCALE, scripts/ellipse_calibration.py).
_SPLIT_STD_SCALE = {2: 1.4826, 4: 2.37}


def split_k(n_seg_total: int) -> int:
    """Sub-accumulations for the empirical error bar: 4 when every group
    holds ≥2 segments, 2 down to 2 segments, else none."""
    if n_seg_total >= 8:
        return 4
    if n_seg_total >= 2:
        return 2
    return 0


def _split_bounds(n_seg_total: int, K: int, unit: int) -> list:
    """K+1 cumulative group boundaries in units of ``unit``; the
    remainder is spread over the first groups (sizes q or q+1)."""
    q, r = divmod(n_seg_total, K)
    bounds = [0]
    for k in range(K):
        bounds.append(bounds[-1] + (q + (1 if k < r else 0)) * unit)
    return bounds


def _combine_splits(cross_g: torch.Tensor, psd_g: torch.Tensor,
                    energy_g: torch.Tensor, pairs, max_lag: int,
                    weighting: str, eps: float, fft_len: int,
                    n_seg_total: int) -> CorrResult:
    """Full-capture CorrResult from K bank accumulators ([K, ...] each),
    with the split empirical error bar folded into ``delay_std``: each
    bank's delay comes from a ±16-lag zoom probe around the full
    estimate, weighted with the OTHER banks' (leave-one-out) factor;
    σ_emp = c_K · std(bank delays)/√K."""
    K, m = int(cross_g.shape[0]), int(cross_g.shape[1])
    n_st = int(psd_g.shape[1])
    cross = cross_g.sum(0)
    psd = psd_g.sum(0)
    energy = energy_g.sum(0)
    res = _finish_correlation(cross, psd, energy, pairs, max_lag, weighting,
                              eps, fft_len, "phase", n_seg=n_seg_total)
    coarse = torch.round(res.delay)
    q, r = divmod(n_seg_total, K)
    n_seg_loo = torch.from_numpy(np.repeat(
        n_seg_total - (q + (np.arange(K) < r).astype(np.int64)), m
    ).astype(np.float32)).to(cross.device)

    from tdoa_tpu_torch.ops.kernels.zoom_probe import (
        loo_zoom_delays,
        zoom_probe_supported,
    )

    if zoom_probe_supported(fft_len, max_lag, weighting):
        ds = loo_zoom_delays(cross_g.contiguous(), psd_g.contiguous(), pairs,
                             coarse, n_seg_loo, eps)
    else:
        # All K probes in one batched pass: banks stack along the pair
        # axis with per-bank station offsets in the pair list.
        loo_cross = (cross[None] - cross_g).reshape(K * m, -1)
        loo_psd = (psd[None] - psd_g).reshape(K * n_st, -1)
        p = np.asarray(pairs, np.int64).reshape(-1, 2)
        pair_big = np.tile(p, (K, 1)) + np.repeat(np.arange(K), m)[:, None] \
            * n_st
        s_k = _weight_factor(loo_cross, loo_psd, pair_big, weighting, eps,
                             n_seg_loo[:, None])
        ds = _zoom_corr_delay(cross_g.reshape(K * m, -1) * s_k,
                              coarse.repeat(K), fft_len, max_lag).reshape(K, m)
    var = ((ds - ds.mean(0)) ** 2).sum(0) / (K - 1)
    sigma_emp = _SPLIT_STD_SCALE[K] * torch.sqrt(var / K)
    return res._replace(delay_std=torch.maximum(res.delay_std, sigma_emp))


def _split_half_sigma(cross_a: torch.Tensor, cross_b: torch.Tensor,
                      wfac_a: torch.Tensor, wfac_b: torch.Tensor,
                      coarse: torch.Tensor, fft_len: int,
                      max_lag: int) -> torch.Tensor:
    """Empirical 1σ (samples) from two half-capture cross-spectra: each
    half's zoom-DFT peak near the full-capture coarse delay, half the
    disagreement, scaled by the MAD consistency constant 1.4826 (a
    single absolute deviation's median is 0.674 σ). ``wfac_a`` weights
    half a's probe and must be computed WITHOUT half a, and vice versa:
    a half must not weight itself, and the full capture's factor would
    drag a corrupted half's probe to the full delay."""
    da = _zoom_corr_delay(cross_a * wfac_a, coarse, fft_len, max_lag)
    db = _zoom_corr_delay(cross_b * wfac_b, coarse, fft_len, max_lag)
    return (0.5 * _SPLIT_STD_SCALE[2]) * (da - db).abs()


# Welch segments a capture should hold: fewer give a biased HT coherence
# and split-σ banks of one segment, whose coherence is identically 1.
TARGET_SEGS = 8


def auto_seg_len(n: int, max_lag: int, seg_len: Optional[int],
                 target_segs: int = TARGET_SEGS,
                 floor: int = 4096) -> Optional[int]:
    """Shrink a configured segment length so SHORT captures still hold
    ``target_segs`` Welch segments (a less-biased HT coherence and a
    multi-dof split σ); long captures keep the configured segment. Never
    shrinks below ``max_lag`` (``resolve_seg``'s alias-free requirement)
    or ``floor`` (frequency resolution)."""
    if seg_len is None:
        return None
    while (n // seg_len < target_segs and seg_len // 2 > max_lag
           and seg_len // 2 >= floor):
        seg_len //= 2
    return seg_len


def resolve_seg(n: int, max_lag: int, seg_len: Optional[int],
                fft_len: Optional[int]) -> Tuple[int, int]:
    """(seg_len, fft_len) of the segmented correlator. Anti-aliasing needs
    ``seg_len + max_lag ≤ fft_len``: the FFT stays at ``next_pow2(seg)``
    and the segment shrinks by max_lag (a ~1 % increase in segment count
    instead of doubling the transform). A whole-signal correlation
    (seg_len=None / seg covers n) pads up instead."""
    whole = seg_len is None or seg_len >= n
    if whole:
        seg_len = n
        if fft_len is None:
            fft_len = next_pow2(seg_len + max_lag)
    elif fft_len is None:
        fft_len = next_pow2(seg_len)
        if seg_len + max_lag > fft_len:
            if max_lag < fft_len // 2:
                seg_len = fft_len - max_lag
            else:
                fft_len = next_pow2(seg_len + max_lag)
    if max_lag >= seg_len:
        raise ValueError(f"max_lag {max_lag} must be < seg_len {seg_len}")
    if seg_len + max_lag > fft_len:
        raise ValueError("fft_len too small for seg_len + max_lag")
    return seg_len, fft_len


def _accumulate_cross_spectra(x: torch.Tensor, pair_idx, seg_len: int,
                              fft_len: int,
                              scale: Optional[torch.Tensor] = None):
    """Segment-accumulated spectra of planar ``x`` [2, n_st, N] (whole
    segments only, each scaled per station by ``scale`` [n_st]): (cross
    c64 [m, F], psd f32 [n_st, F], energy f32 [n_st]). Segments are
    transformed in chunks of at most ``SEG_CHUNK_BYTES``."""
    n_st, n = int(x.shape[1]), int(x.shape[2])
    n_seg = n // seg_len
    from tdoa_tpu_torch.ops.kernels.corr_accum import device_pairs

    dev = x.device
    # The pair list lives on the device once per process: a host→card
    # copy per call would make the host wait for the card every chunk.
    p = device_pairs(pair_idx, dev).long()
    ii, jj = p[:, 0], p[:, 1]
    cross = torch.zeros(len(p), fft_len, dtype=torch.complex64, device=dev)
    psd = torch.zeros(n_st, fft_len, dtype=torch.float32, device=dev)
    energy = torch.zeros(n_st, dtype=torch.float32, device=dev)
    chunk = max(1, SEG_CHUNK_BYTES // ((n_st + len(p)) * fft_len * 8))
    for s0 in range(0, n_seg, chunk):
        s1 = min(s0 + chunk, n_seg)
        seg = x[:, :, s0 * seg_len:s1 * seg_len].to(torch.float32)
        if scale is not None:
            seg = seg * scale[None, :, None]
        energy += (seg[0].square() + seg[1].square()).sum(-1)
        z = torch.complex(seg[0], seg[1]).reshape(n_st, s1 - s0, seg_len)
        spec = torch.fft.fft(z, n=fft_len, dim=-1)  # [n_st, S, F]
        psd += (spec.real.square() + spec.imag.square()).sum(1)
        cross += (spec[jj] * spec[ii].conj()).sum(1)
    return cross, psd, energy


def correlate_pairs_planar(x: torch.Tensor, pair_idx,
                           max_lag: int = DEFAULT_MAX_LAG,
                           seg_len: Optional[int] = None,
                           weighting: str = "phat", eps: float = 1e-3,
                           fft_len: Optional[int] = None,
                           refine: str = "phase") -> CorrResult:
    """All-pairs GCC cross-correlation of planar ``x`` [2, n_st, N].

    ``seg_len=None`` correlates the whole signal in one FFT; otherwise
    the capture streams through ``seg_len``-sample segments with coherent
    accumulation. Every station is first scaled to unit RMS
    (delay-invariant; keeps the HT coherence's 4th powers inside float32
    for inputs of any unit, e.g. FM audio). With ``refine="phase"`` and
    ≥2 segments the K contiguous slices accumulate separately for the
    split empirical error bar (``_combine_splits``)."""
    n = int(x.shape[-1])
    seg_len, fft_len = resolve_seg(n, max_lag, seg_len, fft_len)
    x = x.to(torch.float32)
    # Per-station RMS over groups of rows whose squares each stay within
    # SEG_CHUNK_BYTES: no temporary of the signal's size beside it.
    rows = max(1, SEG_CHUNK_BYTES // (4 * max(n, 1)))
    rms = torch.cat([
        torch.sqrt((x[0, r:r + rows].square()
                    + x[1, r:r + rows].square()).mean(-1))
        for r in range(0, int(x.shape[1]), rows)])
    inv = 1.0 / torch.clamp(rms, min=1e-30)
    n_seg_total = n // seg_len
    K = split_k(n_seg_total) if refine == "phase" else 0
    if K == 0:
        cross, psd, energy = _accumulate_cross_spectra(x, pair_idx, seg_len,
                                                       fft_len, inv)
        return _finish_correlation(cross, psd, energy, pair_idx, max_lag,
                                   weighting, eps, fft_len, refine,
                                   n_seg=n_seg_total)
    bounds = _split_bounds(n_seg_total, K, seg_len)
    accs = [
        _accumulate_cross_spectra(x[..., bounds[k]:bounds[k + 1]], pair_idx,
                                  seg_len, fft_len, inv)
        for k in range(K)
    ]
    cross_g, psd_g, energy_g = (torch.stack(a) for a in zip(*accs))
    return _combine_splits(cross_g, psd_g, energy_g, pair_idx, max_lag,
                           weighting, eps, fft_len, n_seg_total)


def _as_planar(x) -> torch.Tensor:
    """Complex (numpy or torch) ``[..., N]`` or real signals → planar
    float32 ``[2, ..., N]``; a real tensor ``[2, n_st, N]`` is taken as
    planar already, any other real input has a zero imaginary part."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    if x.is_complex():
        x = x.to(torch.complex64)
        return torch.stack([x.real, x.imag])
    x = x.to(torch.float32)
    if x.dim() == 3 and x.shape[0] == 2:
        return x
    return torch.stack([x, torch.zeros_like(x)])


def correlate_pairs(x, pair_idx, max_lag: int = DEFAULT_MAX_LAG,
                    seg_len: Optional[int] = None, weighting: str = "phat",
                    eps: float = 1e-3, fft_len: Optional[int] = None,
                    refine: str = "phase") -> CorrResult:
    """``correlate_pairs_planar`` on complex or real signals ``[n_st, N]``
    (numpy or torch) or planar tensors ``[2, n_st, N]``."""
    return correlate_pairs_planar(
        _as_planar(x), pair_idx, max_lag=max_lag, seg_len=seg_len,
        weighting=weighting, eps=eps, fft_len=fft_len, refine=refine)


def correlate_two(a, b, max_lag: int = DEFAULT_MAX_LAG, **kwargs) -> CorrResult:
    """Correlate one signal pair (complex or real ``[N]``, or planar
    ``[2, N]`` tensors). Positive delay ⇒ ``b`` lags ``a``. Result
    fields have the pair axis squeezed."""
    def one(s):
        if isinstance(s, torch.Tensor) and not s.is_complex() and s.dim() == 2:
            return s.to(torch.float32)
        return _as_planar(s)

    x = torch.stack([one(a), one(b)], dim=1)
    res = correlate_pairs_planar(x, np.array([[0, 1]]), max_lag=max_lag,
                                 **kwargs)
    return CorrResult(*(None if v is None else v[0] for v in res))


def correlate_pairs_fused(x: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                          max_lag: int = DEFAULT_MAX_LAG,
                          weighting: str = "ht", eps: float = 1e-3,
                          refine: str = "phase",
                          remove_dc: bool = False) -> CorrResult:
    """GCC correlation of planar ``x`` [2, n_st, N] through kernel 1
    (fixed geometry: seg 45056, FFT 65536; pair-tiled where one launch
    does not hold the pairs) and the shared finish stage.
    With ``refine="phase"`` and ≥2 segments the capture is accumulated
    as K split banks in ONE kernel call; every bank is scaled by the
    FULL capture's per-station RMS so the banks still sum to the full
    accumulators."""
    from tdoa_tpu_torch.ops.kernels.corr_accum import (
        FFT_LEN,
        SEG_LEN,
        accumulate_cross_spectra,
    )

    if max_lag > FFT_LEN - SEG_LEN:
        raise ValueError(
            f"max_lag {max_lag} exceeds the fused kernel's alias-free "
            f"window {FFT_LEN - SEG_LEN} (= fft {FFT_LEN} − seg {SEG_LEN}); "
            f"use the segmented path (correlate_pairs_planar)")
    n_seg_total = int(x.shape[-1]) // SEG_LEN
    K = split_k(n_seg_total) if refine == "phase" else 0
    if K == 0:
        cross, psd, energy = accumulate_cross_spectra(
            x, pairs, remove_dc=remove_dc, prescale=True)
        return _finish_correlation(cross, psd, energy, pairs, max_lag,
                                   weighting, eps, FFT_LEN, refine,
                                   n_seg=n_seg_total)
    end = n_seg_total * SEG_LEN
    bounds = _split_bounds(n_seg_total, K, SEG_LEN)
    cross_g, psd_g, energy_g = accumulate_cross_spectra(
        x[..., :end], pairs, remove_dc=remove_dc, prescale=False,
        n_splits=K)
    energy_tot = energy_g.sum(0)  # [n_st]
    sc = 1.0 / torch.sqrt(torch.clamp(energy_tot / float(end), min=1e-30))
    p = _pair_index(pairs, x.device)
    s_pair = (sc[p[:, 0]] * sc[p[:, 1]])[None, :, None]
    cross_g = cross_g * s_pair
    psd_g = psd_g * (sc * sc)[None, :, None]
    sizes = torch.tensor(np.diff(bounds), dtype=torch.float32,
                         device=x.device)
    energies = sizes[:, None].expand(K, energy_tot.shape[0])
    return _combine_splits(cross_g, psd_g, energies, pairs, max_lag,
                           weighting, eps, FFT_LEN, n_seg_total)


def clock_correct_blocks(delays, stds, quality, peaks, corr_mag, corr_c,
                         ref_geo_tdoa, clock_correction: bool = True):
    """3-block → clock-corrected-TDOA tail. Inputs are per-block [3, m]
    tensors (order REF₁, TGT, REF₂) and the [3, m, W] windows (magnitude
    and complex). The TGT-midpoint clock offset is the average of the
    two REF reads minus the REF transmitter's geometric TDOA; the
    corrected σ adds the two REF variances at 1/4 each.

    Returns ``(corrected, tgt_delay, ref_delays[m,2], clock,
    quality[3,m], peaks[3,m], corrected_std, tgt_window, tgt_std,
    win_c_blocks[3,m,W] complex)``."""
    ref_delays = torch.stack([delays[0], delays[2]], dim=-1)  # [m, 2]
    tgt_delay = delays[1]
    if clock_correction:
        ref_mid = 0.5 * (ref_delays[:, 0] + ref_delays[:, 1])
        clock = ref_mid - ref_geo_tdoa
        corrected = tgt_delay - clock
        corrected_std = torch.sqrt(
            stds[1] ** 2 + 0.25 * (stds[0] ** 2 + stds[2] ** 2))
    else:
        clock = torch.zeros_like(tgt_delay)
        corrected = tgt_delay
        corrected_std = stds[1]
    return (corrected, tgt_delay, ref_delays, clock, quality, peaks,
            corrected_std, corr_mag[1], stds[1], corr_c)
