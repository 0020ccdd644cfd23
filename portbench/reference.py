"""The plain reference: a window's ``.dat`` bytes → corrected TDOAs and
a fix, in float64 PyTorch, written from the published method and not
from the program.

It imports nothing of ``tdoa_tpu_torch`` (a test holds it to that) and
takes only the bytes the benchmark wrote and the configuration. The
method, stage by stage (the constants are frozen copies of the port's):

- decode: byte ``b`` → ``(b − 127.5) / 127.5``, I then Q, three equal
  blocks ``[REF₁ | TGT | REF₂]``;
- IQ correlation (kernel 1's geometry): segments of 45056 samples, each
  zero-padded to a 65536-point FFT, the ragged tail dropped; each
  station's mean removed per DC group (the traffic names the groups: the
  four split banks of the batch path, the chunks of the overlapped
  ingest); cross-spectra ``Σ X_j X_i*`` and power spectra summed over the
  segments; Hannan–Thomson weighting with the Welch bias of the segment
  count; the inverse FFT over ±max_lag; a parabolic peak; the delay
  refined by a weighted least-squares fit of the cross-spectrum's phase
  about the integer peak (clipped to ±1 sample);
- FM correlation: each channel demeaned, the quadrature discriminator
  ``atan2(x[n]·x*[n−1])·fs/(2π·25 kHz)``, a 127-tap Hann-windowed sinc
  low-pass at 0.45·fs/D decimating by D, the audio demeaned, plain
  (unweighted) segment correlation and the same peak and phase fit, the
  delay scaled by D;
- clock correction: TGT delay − (mean of the two REF delays − the REF
  transmitter's geometric TDOA);
- the fix: a 2-D weighted least-squares (Levenberg–Marquardt) hyperbolic
  solve in the network's ENU frame, weights (peak-to-sidelobe / max)²
  with pairs under 5 gated out, from the centroid and a 40 km ring of
  starts, the lowest residual kept.

``precision="bf16"`` computes the same with every stored value rounded
to bfloat16 and sums taken in bfloat16: the control that the limits are
set against (``control.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench import geo

SEG_LEN = 45056
FFT_LEN = 65536
EPS = 1e-3  # GCC regularisation, relative to the mean magnitude
QUALITY_GATE = 5.0
FM_TAPS = 127
FM_DEVIATION_HZ = 25e3
TWO_PI = 2.0 * np.pi


class Precision:
    """float64 (``"f64"``), or bfloat16 storage and sums (``"bf16"``)."""

    def __init__(self, name: str):
        if name not in ("f64", "bf16"):
            raise ValueError(f"unknown precision {name!r}")
        self.low = name == "bf16"

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if not self.low:
            return x
        if x.is_complex():
            return torch.complex(self.r(x.real), self.r(x.imag))
        return x.to(torch.bfloat16).to(torch.float64)

    def sum(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """A tree sum along ``dim``, rounded at every level."""
        if not self.low:
            return x.sum(dim)
        x = self.r(x.movedim(dim, -1))
        while x.shape[-1] > 1:
            if x.shape[-1] % 2:
                x = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
            x = self.r(x[..., 0::2] + x[..., 1::2])
        return x[..., 0]

    def mean(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return self.r(self.sum(x, dim) / x.shape[dim])


def decode(raw: np.ndarray, device, prec: Precision) -> List[torch.Tensor]:
    """u8 I/Q bytes of one file → its three complex128 blocks [L]."""
    n = raw.size // 6
    b = torch.from_numpy(np.ascontiguousarray(raw[:6 * n])).to(device)
    x = prec.r((b.to(torch.float64) - 127.5) / 127.5).view(3, n, 2)
    return [torch.complex(x[k, :, 0], x[k, :, 1]) for k in range(3)]


def pairs_of(n: int) -> np.ndarray:
    return np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                    np.int64)


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


def _spectra(x: torch.Tensor, pairs: np.ndarray, seg: int, fft: int,
             groups: Sequence[Tuple[int, int]], prec: Precision,
             demean_groups: bool = True):
    """Segment-summed cross [m, F] and power [n_st, F] spectra of x
    [n_st, N], each station's mean removed over each group of segments."""
    n_st = x.shape[0]
    ii = torch.as_tensor(pairs[:, 0], device=x.device)
    jj = torch.as_tensor(pairs[:, 1], device=x.device)
    cross = torch.zeros(len(pairs), fft, dtype=torch.complex128,
                        device=x.device)
    psd = torch.zeros(n_st, fft, dtype=torch.float64, device=x.device)
    chunk = max(1, (1 << 27) // (n_st * fft * 16))
    for g0, g1 in groups:
        mu = (prec.mean(x[:, g0 * seg:g1 * seg], -1) if demean_groups
              else torch.zeros(n_st, dtype=x.dtype, device=x.device))
        for s0 in range(g0, g1, chunk):
            s1 = min(s0 + chunk, g1)
            z = prec.r(x[:, s0 * seg:s1 * seg].reshape(n_st, s1 - s0, seg)
                       - mu[:, None, None])
            spec = prec.r(torch.fft.fft(z, n=fft, dim=-1))
            prod = prec.r(spec[jj] * spec[ii].conj())
            power = prec.r(spec.real.square() + spec.imag.square())
            if prec.low:  # the accumulators, one segment at a time
                for s in range(s1 - s0):
                    cross = prec.r(cross + prod[:, s])
                    psd = prec.r(psd + power[:, s])
            else:
                cross += prod.sum(1)
                psd += power.sum(1)
    return cross, psd


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


def _parabolic(y: torch.Tensor):
    n = y.shape[-1]
    idx = torch.argmax(y, dim=-1)
    ic = idx.clamp(1, n - 2)
    ym1 = torch.gather(y, -1, (ic - 1)[:, None])[:, 0]
    y0 = torch.gather(y, -1, ic[:, None])[:, 0]
    yp1 = torch.gather(y, -1, (ic + 1)[:, None])[:, 0]
    den = ym1 - 2.0 * y0 + yp1
    ok = den.abs() > 1e-12
    off = torch.where(ok, 0.5 * (ym1 - yp1) / torch.where(ok, den, 1.0),
                      torch.zeros_like(den)).clamp(-0.5, 0.5)
    interior = (idx >= 1) & (idx <= n - 2)
    return idx.to(torch.float64) + torch.where(interior, off,
                                               torch.zeros_like(off))


def _quality(y: torch.Tensor, guard: int = 8) -> torch.Tensor:
    """Peak over the mean magnitude outside ±guard lags of it."""
    idx = torch.argmax(y, dim=-1)
    pos = torch.arange(y.shape[-1], device=y.device)
    mask = (pos - idx[:, None]).abs() > guard
    floor = torch.where(mask, y, torch.zeros_like(y)).sum(-1) / mask.sum(-1)
    return y.amax(-1) / floor.clamp(min=1e-12)


def _finish(cross, weighted, max_lag: int, fft: int, prec: Precision):
    """Weighted spectrum → (delay, quality): the lag window's parabolic
    peak, then the phase-slope fit of the plain cross-spectrum about the
    integer peak, the peak's carrier phase as its intercept."""
    r = prec.r(torch.fft.ifft(weighted, dim=-1))
    win_c = torch.cat([r[:, -max_lag:], r[:, :max_lag + 1]], dim=-1)
    win = prec.r(win_c.abs())
    pos = _parabolic(win)
    quality = _quality(win)
    pos_i = torch.round(pos).to(torch.int64)
    coarse = pos_i.to(torch.float64) - max_lag
    peak_phase = torch.angle(torch.gather(win_c, -1, pos_i[:, None])[:, 0])
    f = torch.fft.fftfreq(fft, dtype=torch.float64, device=cross.device)[None]
    w = prec.r(cross.abs().square())
    w = prec.r(w / w.amax(-1, keepdim=True))
    raw = (torch.angle(cross) + TWO_PI * f * coarse[:, None]
           - peak_phase[:, None])
    phi = prec.r(raw - TWO_PI * torch.round(raw / TWO_PI))
    sw = prec.sum(w)
    swf = prec.sum(prec.r(w * f))
    swff = prec.sum(prec.r(w * f * f))
    swp = prec.sum(prec.r(w * phi))
    swfp = prec.sum(prec.r(w * f * phi))
    det = sw * swff - swf * swf
    slope = (sw * swfp - swf * swp) / torch.clamp(det, min=1e-300)
    delta = torch.clamp(-slope / TWO_PI, -1.0, 1.0)
    return prec.r(coarse + delta), quality


def iq_delays(x: torch.Tensor, pairs: np.ndarray, max_lag: int,
              dc: dict, prec: Precision):
    """Per-pair (delay, quality) of one IQ block x [n_st, L]."""
    n_seg = x.shape[-1] // SEG_LEN
    cross, psd = _spectra(x, pairs, SEG_LEN, FFT_LEN, dc_groups(n_seg, dc),
                          prec)
    weighted = _ht_weight(cross, psd, pairs, n_seg, prec)
    return _finish(cross, weighted, max_lag, FFT_LEN, prec)


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
    cross, _ = _spectra(audio, pairs, seg, fft, [(0, n_seg)], prec,
                        demean_groups=False)
    delay, quality = _finish(cross, cross, lag, fft, prec)
    return delay * decim, quality


@dataclasses.dataclass
class Answer:
    """One window's answer: corrected TDOAs (samples) by pair of names,
    (lat°, lon°, elev m) of the fix."""

    tdoa: Dict[Tuple[str, str], float]
    fix_lla: np.ndarray


def window(raws: Dict[str, np.ndarray], cfg: dict, path: dict,
           device, precision: str = "f64") -> Answer:
    """The reference's answer for one window: ``raws`` maps each receiver
    to its file's bytes, ``cfg`` is the configuration, ``path`` the
    traffic's ``reference`` entry (``estimator``: ``iq`` with ``dc``, or
    ``fm`` with ``decim``)."""
    prec = Precision(precision)
    names = sorted(raws)
    pairs = pairs_of(len(names))
    fs = float(cfg["sample_rate"])
    proc = cfg["processor"]
    blocks = [decode(raws[n], device, prec) for n in names]
    delays, quality = [], None
    for b in range(3):
        x = torch.stack([blk[b] for blk in blocks])
        if path["estimator"] == "iq":
            d, q = iq_delays(x, pairs, int(proc["max_lag"]), path["dc"], prec)
        elif path["estimator"] == "fm":
            d, q = fm_delays(x, pairs, int(proc["max_lag"]),
                             int(proc["seg_len"]), fs, int(path["decim"]),
                             prec)
        else:
            raise ValueError(f"unknown estimator {path['estimator']!r}")
        delays.append(d.cpu().numpy())
        if b == 1:
            quality = q.cpu().numpy()
        del x
    del blocks
    st = np.stack([_lla(cfg, n) for n in names])
    ref = geo.lla_to_ecef(_lla(cfg, cfg["ref_tx"]))
    tau = np.linalg.norm(geo.lla_to_ecef(st) - ref, axis=-1) \
        / geo.SPEED_OF_LIGHT * fs
    ref_geo = tau[pairs[:, 1]] - tau[pairs[:, 0]]
    corrected = delays[1] - (0.5 * (delays[0] + delays[2]) - ref_geo)
    fix = solve(st, pairs, corrected / fs * geo.SPEED_OF_LIGHT, quality)
    return Answer({(names[i], names[j]): float(t)
                   for (i, j), t in zip(pairs, corrected)}, fix)


def _lla(cfg: dict, name: str) -> np.ndarray:
    row = next(r for r in cfg["stations"] if r[0] == name)
    return np.asarray(row[1:4], np.float64)


def solve(st_lla: np.ndarray, pairs: np.ndarray, range_diff_m: np.ndarray,
          quality: np.ndarray, iters: int = 200) -> np.ndarray:
    """The 2-D weighted least-squares fix (lat°, lon°, elev m)."""
    origin = geo.network_origin(st_lla)
    st = geo.lla_to_enu(st_lla, origin)
    w = (quality / max(quality.max(), 1e-9)) ** 2
    gated = w * (quality >= QUALITY_GATE)
    if np.count_nonzero(gated) >= min(3, len(pairs)):
        w = gated
    si, sj = st[pairs[:, 0]], st[pairs[:, 1]]
    c = st.mean(0)
    ang = np.arange(8) * (2 * np.pi / 8)
    starts = [c] + [c + 40_000.0 * np.array([np.cos(a), np.sin(a), 0.0])
                    for a in ang]

    def resid(x):
        di, dj = x - si, x - sj
        ri, rj = np.linalg.norm(di, axis=-1), np.linalg.norm(dj, axis=-1)
        jac = dj / (rj[:, None] + 1e-9) - di / (ri[:, None] + 1e-9)
        return (rj - ri) - range_diff_m, jac[:, :2]

    best = None
    for x in starts:
        x = np.array(x, np.float64)
        lam = 1e-2
        for _ in range(iters):
            r, jac = resid(x)
            h = (jac.T * w) @ jac + lam * np.eye(2)
            step = np.linalg.solve(h, -(jac.T * w) @ r)
            x_try = x.copy()
            x_try[:2] += step
            r_try, _ = resid(x_try)
            if (w * r_try ** 2).sum() < (w * r ** 2).sum():
                x, lam = x_try, max(lam / 3.0, 1e-12)
            else:
                lam *= 10.0
        r, _ = resid(x)
        cost = float((w * r ** 2).sum())
        if best is None or cost < best[0]:
            best = (cost, x)
    return geo.enu_to_lla(best[1], origin)
