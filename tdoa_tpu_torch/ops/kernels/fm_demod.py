"""Kernel 3: FM quadrature discriminator + decimating 128-tap FIR.

Replaces ``tdoa_tpu/ops/pallas/fm_demod.py`` (``_kernel`` via
``fm_demod_decimate_pallas``). For every channel of planar IQ
``x`` ``[2, C, n]`` it computes

- ``d[g] = atan2(Im p, Re p)·fs/(2π·dev)`` with ``p = x[g]·conj(x[g−1])``
  and ``dev`` = DEVIATION_HZ (25 kHz, the TPU kernel's default)
  for ``0 < g < n``, and ``d = 0`` at ``g = 0`` (the sample before the
  capture is zero) and past the end;
- ``y[j] = Σ_{k<128} h[k]·d[j·D + k]`` for ``j < n // D``: a causal FIR
  decimated by ``D``, ``h`` = ``lowpass_taps(0.45·fs/D, fs, 127)``
  zero-padded to 128 taps.

The FIR's constant group delay (63 input samples) is common to every
channel and cancels in pair correlation. DC (a receiver LO offset) is
left to the caller. ``D`` must divide 128, as for the TPU kernel.

``fm_demod_decimate`` is the wrapper of ``csrc/fm_demod.cu``: a CUDA
tensor launches it (or raises), a CPU tensor takes
``fm_demod_decimate_plain``, the same sums in torch (``torch.atan2`` and
a loop of strided slices over the taps, no convolution). The kernel
keeps its taps in constant memory, keyed by ``(sample_rate, decim)`` on
the C side: the wrapper hands it the host taps and makes no copy of its
own. Rows that start on 16-byte boundaries (``rows_aligned``) take the
kernel's 16-byte loads, any other view its scalar loads.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from tdoa_tpu_torch.dsp.filters import lowpass_taps

NUM_TAPS = 128
DEVIATION_HZ = 25e3


@functools.lru_cache(maxsize=None)
def fm_taps(sample_rate: float, decim: int) -> np.ndarray:
    """The kernel's FIR: ``lowpass_taps(0.45·fs/D, fs, 127)`` zero-padded
    to NUM_TAPS (f32), as the TPU kernel builds it."""
    taps = lowpass_taps(0.45 * sample_rate / decim, sample_rate, NUM_TAPS - 1)
    return np.concatenate([taps, np.zeros(NUM_TAPS - len(taps), np.float32)])


def _check(x: torch.Tensor, decim: int) -> None:
    if NUM_TAPS % decim != 0:
        raise ValueError(f"decim {decim} must divide {NUM_TAPS}")
    if x.dim() != 3 or x.shape[0] != 2:
        raise ValueError(f"x must be planar [2, C, n], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")


def _inv_dev(sample_rate: float) -> float:
    """fs/(2π·dev) rounded to f32, the reference's scale."""
    return float(np.float32(sample_rate / (2.0 * np.pi * DEVIATION_HZ)))


def fm_demod_decimate_plain(x: torch.Tensor, sample_rate: float,
                            decim: int = 8) -> torch.Tensor:
    """Plain torch version: audio ``[C, n // decim]`` f32 of planar f32
    ``x`` ``[2, C, n]`` — also what the CUDA kernel is held against on
    the card."""
    _check(x, decim)
    n = int(x.shape[-1])
    n_out = n // decim
    y = torch.zeros(x.shape[1], n_out, dtype=torch.float32, device=x.device)
    if n_out == 0:
        return y
    re, im = x[0], x[1]
    p_re = re[:, 1:] * re[:, :-1] + im[:, 1:] * im[:, :-1]
    p_im = im[:, 1:] * re[:, :-1] - re[:, 1:] * im[:, :-1]
    d = torch.atan2(p_im, p_re) * _inv_dev(sample_rate)
    d = F.pad(d, (1, NUM_TAPS))  # d[0] = 0; zeros past the end
    span = (n_out - 1) * decim + 1
    for k, h in enumerate(fm_taps(sample_rate, decim).tolist()):
        y += h * d[:, k:k + span:decim]
    return y


def rows_aligned(x: torch.Tensor) -> bool:
    """Whether every channel row of planar f32 ``x`` ``[2, C, n]`` starts
    on a 16-byte boundary: both planes' base pointers do, and the channel
    stride is a multiple of 4 elements (or there is one channel)."""
    return (x[0].data_ptr() % 16 == 0 and x[1].data_ptr() % 16 == 0
            and (x.shape[1] == 1 or x.stride(1) % 4 == 0))


def fm_demod_decimate(x: torch.Tensor, sample_rate: float,
                      decim: int = 8) -> torch.Tensor:
    """Demodulate and decimate every channel of planar f32 ``x``
    ``[2, C, n]`` (contiguous along n): audio ``[C, n // decim]`` f32,
    scaled so ±DEVIATION_HZ (25 kHz, broadcast FM) maps to ±1.

    CPU tensors take the plain torch version; CUDA tensors launch
    ``csrc/fm_demod.cu`` and count the launch in
    ``fm_demod_decimate.launches`` (and, by ``(C, n, decim)``, in
    ``fm_demod_decimate.launch_shapes``)."""
    if x.device.type == "cpu":
        return fm_demod_decimate_plain(x, sample_rate, decim)
    from tdoa_tpu_torch.ops.kernels import _build
    from tdoa_tpu_torch.utils.platform import require_sm90

    require_sm90(x.device)
    _check(x, decim)
    if x.stride(2) != 1:
        raise ValueError("x must be contiguous along the sample axis")
    C, n = int(x.shape[1]), int(x.shape[2])
    n_out = n // decim
    out = torch.empty(C, n_out, dtype=torch.float32, device=x.device)
    if C == 0 or n_out == 0:
        return out
    lib = _build.load()
    taps = fm_taps(float(sample_rate), decim)  # cached: the pointer stays
    with torch.cuda.device(x.device):  # the taps are per device
        err = lib.tdoa_fm_demod(
            ctypes.c_void_p(x[0].data_ptr()),
            ctypes.c_void_p(x[1].data_ptr()),
            int(x.stride(1)), C, n, decim, float(sample_rate),
            ctypes.c_float(_inv_dev(sample_rate)),
            ctypes.c_void_p(taps.ctypes.data), int(rows_aligned(x)),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    if err != 0:
        raise RuntimeError(f"fm_demod kernel launch failed: CUDA error {err}")
    fm_demod_decimate.launches += 1
    fm_demod_decimate.launch_shapes[(C, n, decim)] += 1
    return out


fm_demod_decimate.launches = 0
fm_demod_decimate.launch_shapes = collections.Counter()
