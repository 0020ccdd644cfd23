"""Kernel 2: the split-σ probe — LOO HT weighting + deramp + zoom DFT.

Replaces ``tdoa_tpu/ops/pallas/zoom_probe.py`` (``_kernel`` via
``loo_zoom_windows_pallas`` / ``loo_zoom_delays_pallas``). For each of
the K·m (bank, pair) probe rows it weights the bank's own
cross-spectrum with the Hannan–Thomson factor of the OTHER banks'
(leave-one-out) coherence, debiased by the LOO segment count, deramps
it by the integer coarse delay with the exact ``(k·d) mod F`` residue,
and sums the ±16-lag zoom DFT window around the coarse peak.

Like the TPU kernel it drops ``_weight_factor``'s per-row
``snr_w / max(snr_w)`` normalization: a positive per-row scalar leaves
the window's argmax and parabolic offset unchanged.

``loo_zoom_windows`` is the wrapper of ``csrc/zoom_probe.cu`` (one
cooperative launch; the zoom basis as ``zoom_basis`` builds it): a CUDA
tensor launches it (or raises), a CPU tensor takes
``loo_zoom_windows_plain``, the same formula in torch.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from tdoa_tpu_torch.ops.kernels.corr_accum import device_pairs, pairs_key
from tdoa_tpu_torch.ops.peaks import parabolic_peak

TILE = 128  # smallest FFT length the CUDA kernel takes (4 bins a lane)
CHUNK = 256  # frequency bins per warp item of the CUDA kernel
HALF_WIDTH = 16  # zoom window: ±16 lags around the coarse peak
W = 2 * HALF_WIDTH + 1


def _check(cross_g, psd_g, pairs, coarse, n_seg_loo):
    if cross_g.dim() != 3 or cross_g.dtype != torch.complex64:
        raise ValueError("cross_g must be complex64 [K, m, F]")
    K, m, F = cross_g.shape
    if psd_g.dim() != 3 or psd_g.shape[0] != K or psd_g.shape[2] != F \
            or psd_g.dtype != torch.float32:
        raise ValueError("psd_g must be float32 [K, n_st, F]")
    n_st = psd_g.shape[1]
    p = pairs_key(pairs)
    if len(p) != m or min(map(min, p)) < 0 or max(map(max, p)) >= n_st:
        raise ValueError(f"pairs {pairs!r} do not match m={m}, n_st={n_st}")
    if coarse.shape != (m,) or n_seg_loo.shape != (K * m,):
        raise ValueError("coarse must be [m] and n_seg_loo [K*m]")
    if not zoom_probe_supported(F, 0, "ht"):
        raise ValueError(f"fft_len {F} is not a power-of-two multiple of "
                         f"TILE {TILE}")
    return K, m, n_st, F


def loo_zoom_windows_plain(cross_g, psd_g, pairs, coarse, n_seg_loo,
                           eps: float = 1e-3):
    """Plain torch version: complex zoom windows [K·m, W] — also what the
    CUDA kernel is held against on the card."""
    K, m, n_st, F = _check(cross_g, psd_g, pairs, coarse, n_seg_loo)
    dev = cross_g.device
    p = torch.as_tensor(np.asarray(pairs, np.int64).reshape(-1, 2),
                        device=dev)
    psd_c = psd_g.clamp(min=0.0)
    rows = []
    for k in range(K):
        others = [kk for kk in range(K) if kk != k]
        c_loo = cross_g[others[0]]
        s_loo = psd_c[others[0]]
        for kk in others[1:]:
            c_loo = c_loo + cross_g[kk]
            s_loo = s_loo + psd_c[kk]
        mag = torch.sqrt(c_loo.real.square() + c_loo.imag.square())  # [m, F]
        denom = torch.sqrt(s_loo[p[:, 0]]) * torch.sqrt(s_loo[p[:, 1]])
        mean_mag = mag.mean(-1, keepdim=True)
        mean_den = denom.mean(-1, keepdim=True)
        gamma = mag / denom.clamp(min=1e-30)
        g2 = (gamma * gamma).clamp(0.0, 0.98)
        s = n_seg_loo[k * m:(k + 1) * m, None].to(torch.float32)
        bias = torch.where(s > 1.0, 1.0 / s.clamp(min=1.0),
                           torch.zeros_like(s))
        g2 = ((g2 - bias) / (1.0 - bias).clamp(min=1e-6)).clamp(0.0, 0.98)
        snr_w = g2 / (1.0 - g2)
        snr_w = torch.where(denom > 1e-9 * mean_den, snr_w,
                            torch.zeros_like(snr_w))
        w = snr_w / (mag + eps * mean_mag + 1e-30)
        rows.append(cross_g[k] * w)
    weighted = torch.cat(rows)  # [K·m, F]
    # Exact integer deramp (k·d) mod F: int64 products, non-negative residue.
    k_idx = torch.arange(F, device=dev, dtype=torch.int64)
    d = torch.round(coarse).to(torch.int64).repeat(K)
    frac = (k_idx[None, :] * d[:, None]) % F
    step = torch.tensor(2.0 * np.pi / F, dtype=torch.float32)
    ang = frac.to(torch.float32) * step.to(dev)
    der = weighted * torch.polar(torch.ones_like(ang), ang)
    k_signed = torch.where(k_idx < F // 2, k_idx, k_idx - F).to(torch.float32)
    delta = torch.arange(-HALF_WIDTH, HALF_WIDTH + 1, device=dev,
                         dtype=torch.float32)
    ang2 = (k_signed * step.to(dev))[:, None] * delta[None, :]  # [F, W]
    basis = torch.polar(torch.ones_like(ang2), ang2)
    return der @ basis


def zoom_basis(F: int) -> torch.Tensor:
    """The CUDA kernel's zoom basis exp(+2πi·k_signed·δ/F), complex64
    [F, W] on the CPU: lag 1 from the exact angle (2·k_signed/F half
    turns, what ``sincospif`` takes, correctly rounded), lags 2..16 by
    the float32 recurrence b_{n+1} = b_n·b_1, negative lags the
    conjugates. Its error grows by about one rounding a step (≲ 2e-6 at
    lag 16), below the plain version's own f32 angle rounding."""
    k = torch.arange(F, dtype=torch.float64)
    ang = math.pi * (2.0 * torch.where(k < F // 2, k, k - F) / F)
    c1, s1 = torch.cos(ang).float(), torch.sin(ang).float()
    br, bi = c1, s1
    pos_re, pos_im = [], []
    for _ in range(HALF_WIDTH):
        pos_re.append(br)
        pos_im.append(bi)
        br, bi = br * c1 - bi * s1, br * s1 + bi * c1
    re = pos_re[::-1] + [torch.ones(F)] + pos_re
    im = [-v for v in pos_im[::-1]] + [torch.zeros(F)] + pos_im
    return torch.complex(torch.stack(re, -1), torch.stack(im, -1))


def loo_zoom_windows(cross_g: torch.Tensor, psd_g: torch.Tensor, pairs,
                     coarse: torch.Tensor, n_seg_loo: torch.Tensor,
                     eps: float = 1e-3) -> torch.Tensor:
    """Complex zoom windows [K·m, W] around ``coarse`` (rounded [m]
    delays) for every (bank, pair) probe. ``cross_g`` complex64
    [K, m, F], ``psd_g`` f32 [K, n_st, F], ``n_seg_loo`` [K·m].

    CPU tensors take the plain torch version; CUDA tensors launch
    ``csrc/zoom_probe.cu`` and count the launch in
    ``loo_zoom_windows.launches``."""
    if cross_g.device.type == "cpu":
        return loo_zoom_windows_plain(cross_g, psd_g, pairs, coarse,
                                      n_seg_loo, eps)
    from tdoa_tpu_torch.ops.kernels import _build
    from tdoa_tpu_torch.utils.platform import require_sm90

    require_sm90(cross_g.device)
    K, m, n_st, F = _check(cross_g, psd_g, pairs, coarse, n_seg_loo)
    if not (cross_g.is_contiguous() and psd_g.is_contiguous()):
        raise ValueError("cross_g and psd_g must be contiguous")
    lib = _build.load()
    dev = cross_g.device
    pairs_d = device_pairs(pairs, dev)
    coarse_d = coarse.to(device=dev, dtype=torch.float32).contiguous()
    nseg_d = n_seg_loo.to(device=dev, dtype=torch.float32).contiguous()
    KM, n_ch = K * m, F // min(CHUNK, F)
    # One scratch allocation: per-bin float4 [KM, F] | chunk sums
    # [KM, n_ch, 2] | chunk windows [KM, n_ch, 2W] | barrier counter.
    scratch = torch.empty(KM * F * 4 + KM * n_ch * (2 + 2 * W) + 1,
                          dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    part_at = base + 4 * KM * F * 4
    zpart_at = part_at + 4 * KM * n_ch * 2
    bar_at = zpart_at + 4 * KM * n_ch * 2 * W
    out = torch.empty(KM, W, dtype=torch.complex64, device=dev)
    err = lib.tdoa_zoom_probe(
        ctypes.c_void_p(cross_g.data_ptr()), ctypes.c_void_p(psd_g.data_ptr()),
        ctypes.c_void_p(pairs_d.data_ptr()),
        ctypes.c_void_p(coarse_d.data_ptr()),
        ctypes.c_void_p(nseg_d.data_ptr()), K, m, n_st, F, float(eps),
        ctypes.c_void_p(base), ctypes.c_void_p(part_at),
        ctypes.c_void_p(zpart_at), ctypes.c_void_p(bar_at),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"zoom_probe kernel launch failed: CUDA error {err}")
    loo_zoom_windows.launches += 1
    return out


loo_zoom_windows.launches = 0


def loo_zoom_delays(cross_g, psd_g, pairs, coarse, n_seg_loo,
                    eps: float = 1e-3) -> torch.Tensor:
    """Per-probe zoom delays [K, m]: |window| parabolic-peaked, plus
    ``coarse − HALF_WIDTH``."""
    K, m = cross_g.shape[0], cross_g.shape[1]
    win = loo_zoom_windows(cross_g, psd_g, pairs, coarse, n_seg_loo, eps).abs()
    pos, _ = parabolic_peak(win)
    return (coarse.repeat(K) + pos - float(HALF_WIDTH)).reshape(K, m)


def zoom_probe_supported(fft_len: int, max_lag: int, weighting: str) -> bool:
    """Static gate for routing ``_combine_splits`` through the probe
    kernel: HT/ML weighting (the kernel's formula), a power-of-two FFT
    length that tiles by TILE (the residue ``(k·d) & (F−1)`` is
    ``(k·d) mod F`` only for 2^n), and the int32 deramp guard
    ``k·d < 2³¹`` shared with ``_zoom_corr_delay``."""
    return (
        weighting in ("ht", "ml")
        and fft_len >= TILE
        and (fft_len & (fft_len - 1)) == 0
        and fft_len % TILE == 0
        and fft_len * (max_lag + HALF_WIDTH + 1) < 2**31
    )
