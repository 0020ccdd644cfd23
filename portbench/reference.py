"""The plain reference: a window's ``.dat`` bytes → corrected TDOAs and
a fix, in float64 PyTorch, written from the published method and not
from the program.

It imports nothing of ``tdoa_tpu_torch`` (a test holds it to that) and
takes only the bytes the benchmark wrote and the configuration. This
file holds the steps every estimator shares (the constants are frozen
copies of the port's); an estimator, ``estimators/<name>.py`` (the
traffic's ``reference.estimator``), gives a block's per-pair delays and
composes the steps into its ``window``:

- decode: byte ``b`` → ``(b − 127.5) / 127.5``, I then Q, three equal
  blocks ``[REF₁ | TGT | REF₂]``;
- the per-block delays (``per_block``): the estimator's delay and
  quality of each receiver pair, block by block, on all receivers'
  samples of that block; the segment-summed cross- and power spectra,
  the lag window's parabolic peak and the delay refined by a weighted
  least-squares fit of the cross-spectrum's phase about the integer peak
  (clipped to ±1 sample) are here for the estimators to use;
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
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench import geo

QUALITY_GATE = 5.0
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


def spectra(x: torch.Tensor, pairs: np.ndarray, seg: int, fft: int,
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


def finish(cross, weighted, max_lag: int, fft: int, prec: Precision):
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


@dataclasses.dataclass
class Answer:
    """One window's answer: corrected TDOAs (samples) by pair of names,
    (lat°, lon°, elev m) of the fix, and any named outputs beyond them
    that a cell's checks compare (``checks/<name>.py``)."""

    tdoa: Dict[Tuple[str, str], float]
    fix_lla: np.ndarray
    outputs: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Blocks:
    """The per-block delays of one window: receivers by name (sorted),
    their pairs (indices into ``names``), each block's per-pair delay
    (samples; REF₁, TGT, REF₂) and the TGT block's per-pair quality."""

    names: List[str]
    pairs: np.ndarray
    delays: List[np.ndarray]
    quality: np.ndarray


Estimate = Callable[[torch.Tensor, np.ndarray, Precision],
                    Tuple[torch.Tensor, torch.Tensor]]


def per_block(raws: Dict[str, np.ndarray], device, prec: Precision,
              estimate: Estimate) -> Blocks:
    """Decode every receiver's file (``raws``: its bytes by name) and run
    ``estimate(x [receivers, L], pairs, prec) -> (delay, quality)`` on
    each block in turn."""
    names = sorted(raws)
    pairs = pairs_of(len(names))
    blocks = [decode(raws[n], device, prec) for n in names]
    delays, quality = [], None
    for b in range(3):
        x = torch.stack([blk[b] for blk in blocks])
        d, q = estimate(x, pairs, prec)
        delays.append(d.cpu().numpy())
        if b == 1:
            quality = q.cpu().numpy()
        del x
    del blocks
    return Blocks(names, pairs, delays, quality)


def answer(cfg: dict, blk: Blocks) -> Answer:
    """Clock correction against the REF transmitter's geometry, then the
    fix."""
    fs = float(cfg["sample_rate"])
    names, pairs, delays = blk.names, blk.pairs, blk.delays
    st = np.stack([_lla(cfg, n) for n in names])
    ref = geo.lla_to_ecef(_lla(cfg, cfg["ref_tx"]))
    tau = np.linalg.norm(geo.lla_to_ecef(st) - ref, axis=-1) \
        / geo.SPEED_OF_LIGHT * fs
    ref_geo = tau[pairs[:, 1]] - tau[pairs[:, 0]]
    corrected = delays[1] - (0.5 * (delays[0] + delays[2]) - ref_geo)
    fix = solve(st, pairs, corrected / fs * geo.SPEED_OF_LIGHT, blk.quality)
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
