"""The FM estimator of the plain reference, the traffic's ``reference``:
``{"estimator": "fm", "decim": D}``.

Each block on its own: each channel demeaned, the quadrature
discriminator ``atan2(x[n]·x*[n−1])·fs/(2π·25 kHz)``, a 127-tap
Hann-windowed sinc low-pass at 0.45·fs/D decimating by D, the audio
demeaned, plain (unweighted) segment correlation and the shared peak and
phase fit (``reference.finish``), the delay scaled by D; then the clock
correction and the fix (``reference.answer``)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import reference
from portbench.reference import TWO_PI, Answer, Precision

FM_TAPS = 127
FM_DEVIATION_HZ = 25e3


def lowpass_taps(cutoff_hz: float, fs: float, num_taps: int) -> np.ndarray:
    """Hann-windowed sinc low-pass of unity DC gain, float32."""
    fc = cutoff_hz / fs
    k = np.arange(num_taps) - (num_taps - 1) / 2
    h = 2 * fc * np.sinc(2 * fc * k)
    n = np.arange(num_taps)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / (num_taps - 1))
    h *= hann.astype(np.float32)
    return (h / h.sum()).astype(np.float32)


def fm_audio(x: torch.Tensor, fs: float, decim: int, prec: Precision):
    """Discriminator and decimating low-pass of each row of x [C, L]."""
    x = prec.r(x - prec.mean(x, -1)[:, None])
    p = prec.r(x[:, 1:] * x[:, :-1].conj())
    scale = float(np.float32(fs / (TWO_PI * FM_DEVIATION_HZ)))
    d = prec.r(torch.atan2(p.imag, p.real) * scale)
    d = torch.nn.functional.pad(d, (1, FM_TAPS + 1))
    taps = lowpass_taps(0.45 * fs / decim, fs, FM_TAPS).astype(np.float64)
    n_out = x.shape[-1] // decim
    span = (n_out - 1) * decim + 1
    y = torch.zeros(x.shape[0], n_out, dtype=torch.float64, device=x.device)
    for k, h in enumerate(taps.tolist()):
        y = prec.r(y + prec.r(h * d[:, k:k + span:decim]))
    return prec.r(y - prec.mean(y, -1)[:, None])


def fm_delays(x: torch.Tensor, pairs: np.ndarray, max_lag: int,
              seg_len: int, fs: float, decim: int, prec: Precision):
    """Per-pair (delay in IQ samples, quality) of one block's FM audio."""
    audio = fm_audio(x, fs, decim, prec).to(torch.complex128)
    lag = max(max_lag // decim + 2, 16)
    seg = max(seg_len // decim, 4 * lag)
    fft = 1 << (seg - 1).bit_length()
    if seg + lag > fft:
        if lag < fft // 2:
            seg = fft - lag
        else:
            fft = 1 << (seg + lag - 1).bit_length()
    n_seg = audio.shape[-1] // seg
    cross, _ = reference.spectra(audio, pairs, seg, fft, [(0, n_seg)],
                                 prec, demean_groups=False)
    delay, quality = reference.finish(cross, cross, lag, fft, prec)
    return delay * decim, quality


def window(raws: Dict[str, np.ndarray], cfg: dict, path: dict,
           device, precision: str = "f64") -> Answer:
    """The reference's answer for one window: ``raws`` maps each receiver
    to its file's bytes, ``path`` is the traffic's ``reference`` entry."""
    prec = Precision(precision)
    fs = float(cfg["sample_rate"])
    proc = cfg["processor"]
    blk = reference.per_block(
        raws, device, prec,
        lambda x, pairs, p: fm_delays(x, pairs, int(proc["max_lag"]),
                                      int(proc["seg_len"]), fs,
                                      int(path["decim"]), p))
    return reference.answer(cfg, blk)
