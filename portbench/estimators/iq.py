"""The IQ estimator of the plain reference (kernel 1's geometry), the
traffic's ``reference``: ``{"estimator": "iq", "dc": {"kind": "banks"}}``
or ``{"kind": "chunks", "chunk_segs": n}``.

Each block on its own: segments of 45056 samples, each zero-padded to a
65536-point FFT, the ragged tail dropped; each station's mean removed
per DC group (the four split banks of the batch path, the chunks of the
overlapped ingest); cross-spectra ``Σ X_j X_i*`` and power spectra
summed over the segments; Hannan–Thomson weighting with the Welch bias
of the segment count; the inverse FFT over ±max_lag; the shared peak and
phase fit (``reference.finish``); then the clock correction and the fix
(``reference.answer``)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import reference
from portbench.reference import Answer, Precision

SEG_LEN = 45056
FFT_LEN = 65536
EPS = 1e-3  # GCC regularisation, relative to the mean magnitude


def split_bounds(n: int, k: int) -> List[int]:
    """k + 1 bounds of n items in k groups, the first n % k one larger."""
    q, r = divmod(n, k)
    b = [0]
    for i in range(k):
        b.append(b[-1] + q + (1 if i < r else 0))
    return b


def dc_groups(n_seg: int, spec: dict) -> List[Tuple[int, int]]:
    """Segment ranges over which a station's mean is removed."""
    if spec["kind"] == "banks":
        b = split_bounds(n_seg, 4 if n_seg >= 8 else 2)
    elif spec["kind"] == "chunks":
        step = int(spec["chunk_segs"])
        b = list(range(0, n_seg, step)) + [n_seg]
    else:
        raise ValueError(f"unknown DC grouping {spec!r}")
    return list(zip(b[:-1], b[1:]))


def _ht_weight(cross, psd, pairs, n_seg: int, prec: Precision):
    """The Hannan–Thomson weighted spectrum: the phase transform times
    the bias-corrected coherence weight |γ|²/(1 − |γ|²), normalised."""
    mag = prec.r(cross.abs())
    ii = torch.as_tensor(pairs[:, 0], device=psd.device)
    jj = torch.as_tensor(pairs[:, 1], device=psd.device)
    saa = torch.clamp(psd[ii], min=0.0)
    sbb = torch.clamp(psd[jj], min=0.0)
    denom = prec.r(torch.sqrt(saa) * torch.sqrt(sbb))
    g2 = torch.clamp(prec.r(mag / torch.clamp(denom, min=1e-30)) ** 2,
                     0.0, 0.98)
    bias = 1.0 / n_seg if n_seg > 1 else 0.0
    g2 = torch.clamp(prec.r((g2 - bias) / max(1.0 - bias, 1e-6)), 0.0, 0.98)
    snr = prec.r(g2 / (1.0 - g2))
    floor = 1e-9 * prec.mean(denom, -1)[:, None]
    snr = torch.where(denom > floor, snr, torch.zeros_like(snr))
    d = prec.r(mag + EPS * prec.mean(mag, -1)[:, None] + 1e-30)
    w = prec.r(snr / torch.clamp(snr.amax(-1, keepdim=True), min=1e-30))
    return prec.r(cross * prec.r(w / d))


def iq_delays(x: torch.Tensor, pairs: np.ndarray, max_lag: int,
              dc: dict, prec: Precision):
    """Per-pair (delay, quality) of one IQ block x [n_st, L]."""
    n_seg = x.shape[-1] // SEG_LEN
    cross, psd = reference.spectra(x, pairs, SEG_LEN, FFT_LEN,
                                   dc_groups(n_seg, dc), prec)
    weighted = _ht_weight(cross, psd, pairs, n_seg, prec)
    return reference.finish(cross, weighted, max_lag, FFT_LEN, prec)


def window(raws: Dict[str, np.ndarray], cfg: dict, path: dict,
           device, precision: str = "f64") -> Answer:
    """The reference's answer for one window: ``raws`` maps each receiver
    to its file's bytes, ``path`` is the traffic's ``reference`` entry."""
    prec = Precision(precision)
    max_lag = int(cfg["processor"]["max_lag"])
    blk = reference.per_block(
        raws, device, prec,
        lambda x, pairs, p: iq_delays(x, pairs, max_lag, path["dc"], p))
    return reference.answer(cfg, blk)
