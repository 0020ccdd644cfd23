"""Kernel 1: segment FFT + cross-spectra + banked accumulation.

Replaces ``tdoa_tpu/ops/pallas/corr_accum.py`` (``_kernel`` via
``accumulate_cross_spectra_pallas``). Each 45056-sample segment of
every station is zero-padded to 65536 and transformed; over the
segments of each of ``n_splits`` contiguous banks (bounded exactly like
``ops.corr._split_bounds``) the kernel accumulates per-pair
cross-spectra ``X_j·conj(X_i)``, per-station PSD ``|X|²`` and, for DC
removal, per-station spectral sums ``ΣX`` — all in TRUE frequency
order. ``_finalize_banks`` then folds in the DC removal
(``FFT(x−m) = FFT(x) − m·D``) and the optional unit-RMS prescale.

The CUDA kernel (``csrc/corr_accum.cu``) computes the transform in its
own body (four-step 256×256, f32 arithmetic on bf16 or f32 input).
``accumulate_banks`` is its wrapper: a CUDA tensor launches it (or
raises), a CPU tensor takes ``accumulate_banks_plain``, the same sums
with ``torch.fft`` — also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

R = 256  # radix: FFT_LEN = R*R
SEG_ROWS = 176  # data rows per segment; the other 80 rows are zero padding
FFT_LEN = R * R  # 65536
SEG_LEN = SEG_ROWS * R  # 45056

# Scratch for the stage-1 spectra of one chunk of segments is bounded by
# this many bytes (three stations × 443 segments would be ~680 MB).
SCRATCH_BYTES = 64 << 20
# Largest dynamic shared memory one CTA may opt into on sm_90.
SM90_SMEM_OPTIN = 232448


@functools.lru_cache(maxsize=None)
def _dc_window_np() -> np.ndarray:
    d = np.fft.fft(np.ones(SEG_LEN), FFT_LEN)
    return d.astype(np.complex64)


def _dc_window(device) -> torch.Tensor:
    """FFT of the segment's rectangular window (SEG_LEN ones, zero-padded
    to FFT_LEN), true frequency order, complex64 on ``device``."""
    return torch.from_numpy(_dc_window_np()).to(device)


def bank_bounds(n_seg: int, n_banks: int) -> list:
    """Segment-index bounds of the banks: the first ``n_seg % n_banks``
    banks hold one segment more (``ops.corr._split_bounds`` in units of
    segments)."""
    q, r = divmod(n_seg, n_banks)
    b = [0]
    for k in range(n_banks):
        b.append(b[-1] + q + (1 if k < r else 0))
    return b


def _pairs_tensor(pairs: Sequence[Tuple[int, int]], device) -> torch.Tensor:
    return torch.tensor(np.asarray(pairs, np.int32).reshape(-1, 2),
                        dtype=torch.int32, device=device)


def _check_input(x: torch.Tensor, pairs) -> Tuple[int, int, int]:
    if x.dim() != 3 or x.shape[0] != 2:
        raise ValueError(f"x must be planar [2, n_st, N], got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    n_st, n = int(x.shape[1]), int(x.shape[2])
    p = np.asarray(pairs).reshape(-1, 2)
    if p.size == 0 or p.min() < 0 or p.max() >= n_st:
        raise ValueError(f"pairs {pairs!r} invalid for {n_st} stations")
    n_seg = n // SEG_LEN
    if n_seg == 0:
        raise ValueError(
            f"capture length {n} is shorter than one kernel segment "
            f"(SEG_LEN={SEG_LEN}); short captures take the segmented "
            f"path (ops.corr.correlate_pairs_planar)")
    return n_st, n_seg, len(p)


def accumulate_banks_plain(x: torch.Tensor, pairs, n_banks: int,
                            track_sums: bool, chunk: int = 16):
    """Plain torch version of the kernel: same banks, same sums, with
    ``torch.fft`` on complex64. Returns (cross c64 [K, m, F], psd f32
    [K, n_st, F], sums c64 [K, n_st, F] or None)."""
    n_st, n_seg, m = _check_input(x, pairs)
    p = np.asarray(pairs, np.int64).reshape(-1, 2)
    dev = x.device
    ii = torch.from_numpy(p[:, 0]).to(dev)
    jj = torch.from_numpy(p[:, 1]).to(dev)
    cross = torch.zeros(n_banks, m, FFT_LEN, dtype=torch.complex64, device=dev)
    psd = torch.zeros(n_banks, n_st, FFT_LEN, dtype=torch.float32, device=dev)
    sums = (torch.zeros(n_banks, n_st, FFT_LEN, dtype=torch.complex64,
                        device=dev) if track_sums else None)
    bounds = bank_bounds(n_seg, n_banks)
    for b in range(n_banks):
        for s0 in range(bounds[b], bounds[b + 1], chunk):
            s1 = min(s0 + chunk, bounds[b + 1])
            seg = x[:, :, s0 * SEG_LEN:s1 * SEG_LEN].to(torch.float32)
            z = torch.complex(seg[0], seg[1]).reshape(n_st, s1 - s0, SEG_LEN)
            spec = torch.fft.fft(z, n=FFT_LEN, dim=-1)  # [n_st, S, F]
            psd[b] += (spec.real.square() + spec.imag.square()).sum(1)
            if track_sums:
                sums[b] += spec.sum(1)
            cross[b] += (spec[jj] * spec[ii].conj()).sum(1)
    return cross, psd, sums


def chunk_segments(n_st: int, n_seg: int) -> int:
    """Segments per stage-1 chunk: scratch stays within SCRATCH_BYTES."""
    per_seg = n_st * FFT_LEN * 8
    return max(1, min(n_seg, SCRATCH_BYTES // per_seg))


def fits_device(n_st: int, m: int, track_sums: bool, n_banks: int,
                device: torch.device) -> bool:
    """Whether the kernel's shared memory (the stage-2 CTA's footprint,
    by the kernel's own formula in the built library) and its device
    buffers (chunk scratch plus the bank accumulators) fit ``device``."""
    from tdoa_tpu_torch.ops.kernels import _build

    smem = _build.load().tdoa_corr_accum_smem_bytes(n_st, m, int(track_sums))
    if smem > SM90_SMEM_OPTIN:
        return False
    scratch = n_st * chunk_segments(n_st, 1 << 30) * FFT_LEN * 8
    acc = n_banks * FFT_LEN * (8 * m + 4 * n_st + (8 * n_st if track_sums
                                                    else 0))
    free, _ = torch.cuda.mem_get_info(device)
    return scratch + acc < free


def accumulate_banks(x: torch.Tensor, pairs, n_banks: int = 1,
                     track_sums: bool = False):
    """Raw banked accumulators of planar ``x`` [2, n_st, N] (bf16 or
    f32; N truncated to whole segments): (cross c64 [K, m, F], psd f32
    [K, n_st, F], sums c64 [K, n_st, F] or None), true frequency order.

    CPU tensors take the plain torch version; CUDA tensors launch
    ``csrc/corr_accum.cu`` and count the launch in
    ``accumulate_banks.launches``."""
    if x.device.type == "cpu":
        return accumulate_banks_plain(x, pairs, n_banks, track_sums)
    from tdoa_tpu_torch.ops.kernels import _build
    from tdoa_tpu_torch.utils.platform import require_sm90

    require_sm90(x.device)
    n_st, n_seg, m = _check_input(x, pairs)
    if x.stride(2) != 1:
        raise ValueError("x must be contiguous along the sample axis")
    if not 1 <= n_banks <= n_seg:
        raise ValueError(f"n_banks {n_banks} outside [1, {n_seg} segments]")
    lib = _build.load()
    dev = x.device
    pairs_d = _pairs_tensor(pairs, dev)
    chunk = chunk_segments(n_st, n_seg)
    scratch = torch.empty(n_st * chunk * FFT_LEN * 2, dtype=torch.float32,
                          device=dev)
    cross = torch.empty(n_banks, m, FFT_LEN, dtype=torch.complex64, device=dev)
    psd = torch.empty(n_banks, n_st, FFT_LEN, dtype=torch.float32, device=dev)
    sums = (torch.empty(n_banks, n_st, FFT_LEN, dtype=torch.complex64,
                        device=dev) if track_sums else None)
    err = lib.tdoa_corr_accum(
        ctypes.c_void_p(x[0].data_ptr()), ctypes.c_void_p(x[1].data_ptr()),
        int(x.dtype == torch.bfloat16), int(x.stride(1)), n_st, n_seg,
        ctypes.c_void_p(pairs_d.data_ptr()), m, n_banks, int(track_sums),
        ctypes.c_void_p(scratch.data_ptr()), chunk,
        ctypes.c_void_p(cross.data_ptr()), ctypes.c_void_p(psd.data_ptr()),
        ctypes.c_void_p(0 if sums is None else sums.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"corr_accum kernel launch failed: CUDA error {err}")
    accumulate_banks.launches += 1
    return cross, psd, sums


accumulate_banks.launches = 0


def _finalize_banks(cross, psd, sums, pairs, seg_g, remove_dc: bool,
                    prescale: bool):
    """Accumulator banks → finalized spectra: the DC-removal algebra and
    (optionally) the deferred unit-RMS prescale, batched over the bank
    axis G. ``seg_g`` is the per-bank segment count. Returns (cross c64
    [G, m, F], psd [G, n_st, F], energy [G, n_st])."""
    dev = cross.device
    p = np.asarray(pairs, np.int64).reshape(-1, 2)
    ii, jj = torch.from_numpy(p[:, 0]).to(dev), torch.from_numpy(p[:, 1]).to(dev)
    seg_g = torch.as_tensor(np.asarray(seg_g, np.float32), device=dev)
    use_g = seg_g * SEG_LEN  # [G]
    if remove_dc:
        # Bank mean from the spectral sum's DC bin: Σ_seg X(0) = Σ xₙ.
        mean = sums[:, :, 0] / use_g[:, None]  # [G, n_st] c64
        a = mean[..., None] * _dc_window(dev)  # A_st = m_st · D
        aj, ai = a[:, jj], a[:, ii]
        si, sj = sums[:, ii], sums[:, jj]
        ns = seg_g[:, None, None]
        # Σ(Xⱼ−Aⱼ)(Xᵢ−Aᵢ)* = cross − Aⱼ∘S̄ᵢ − Āᵢ∘Sⱼ + n_seg·Aⱼ∘Āᵢ
        cross = cross - aj * si.conj() - ai.conj() * sj + ns * (aj * ai.conj())
        # Σ|X−A|² = psd − 2Re(Ā∘S) + n_seg|A|²; clamp the DC bin's f32
        # cancellation, which can round slightly negative.
        a_re, a_im = a.real, a.imag
        psd = torch.clamp(
            psd - 2.0 * (a_re * sums.real + a_im * sums.imag)
            + ns * (a_re * a_re + a_im * a_im),
            min=0.0,
        )
    # Demeaned per-station power via Parseval: Σₙ|x−m|² = (1/F)Σₖ psd'.
    power_dm = torch.clamp(psd.sum(-1) / FFT_LEN / use_g[:, None], min=1e-30)
    if prescale:
        sc = 1.0 / torch.sqrt(power_dm)  # [G, n_st]
        s_pair = sc[:, ii] * sc[:, jj]
        cross = cross * s_pair[..., None]
        psd = psd * (sc * sc)[..., None]
        energy = use_g[:, None].expand_as(power_dm)
    else:
        energy = power_dm * use_g[:, None]
    return cross, psd, energy


def accumulate_cross_spectra(x: torch.Tensor, pairs, remove_dc: bool = False,
                             prescale: bool = False, n_splits: int = 1):
    """Finalized spectra of planar ``x`` [2, n_st, N]: (cross c64 [m, F],
    psd [n_st, F], energy [n_st]), or with ``n_splits=K > 1`` a leading
    bank axis on each — ``accumulate_cross_spectra_pallas``'s contract.
    ``remove_dc`` subtracts each bank's mean, ``prescale`` normalizes to
    unit RMS (single bank only: per-bank RMS would break the
    banks-sum-to-full invariant)."""
    if n_splits > 1 and prescale:
        raise ValueError("prescale with n_splits > 1 is ill-defined; scale "
                         "the banks by the full capture's RMS in the caller")
    n_seg = int(x.shape[-1]) // SEG_LEN
    if n_splits > max(n_seg, 1):
        raise ValueError(f"n_splits {n_splits} exceeds the segment count "
                         f"{n_seg}")
    cross, psd, sums = accumulate_banks(x, pairs, n_splits, remove_dc)
    b = bank_bounds(n_seg, n_splits)
    seg_g = np.diff(np.asarray(b)).astype(np.float32)
    cross, psd, energy = _finalize_banks(cross, psd, sums, pairs, seg_g,
                                         remove_dc, prescale)
    if n_splits == 1:
        return cross[0], psd[0], energy[0]
    return cross, psd, energy

