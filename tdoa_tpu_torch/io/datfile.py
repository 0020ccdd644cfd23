"""The ``.dat`` capture codec — the system's central data contract.

A capture is interleaved unsigned-8-bit I/Q at 2 Msps, centered at 127.5,
laid out as three equal sample blocks ``[REF | TGT | REF]``. Byte value
``b`` decodes to ``(b - 127.5) / 127.5``; encode/decode is bit-faithful
to ``tdoa_tpu.io.datfile``.

Decoding runs on the device: the u8 bytes cross to the card and widen
there (1 byte per component on the link instead of 4). Blocks are
planar real tensors ``[2, L]`` (row 0 = I, row 1 = Q) — the layout the
correlator kernel reads; ``dtype=torch.bfloat16`` decodes straight into
its operand storage.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from tdoa_tpu_torch.utils.constants import IQ_CENTER, IQ_SCALE, NUM_BLOCKS
from tdoa_tpu_torch.utils.platform import default_device


def bytes_to_iq_planar(raw: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decode interleaved u8 I/Q bytes ``[2n]`` to planar ``[2, n]``
    ``dtype`` on ``raw``'s device. The arithmetic is f32 and rounds
    once to ``dtype``, exactly as the JAX decode does."""
    x = (raw.to(torch.float32) - IQ_CENTER) / IQ_SCALE
    return x.to(dtype).view(-1, 2).t().contiguous()


def u16_to_iq_planar(packed: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decode little-endian-packed uint16 I/Q words ``[..., L]`` (I = low
    byte, Q = high byte) to planar ``[2, ..., L]`` ``dtype`` on
    ``packed``'s device. The words are read as the bytes they are (no
    uint16 arithmetic) with ``bytes_to_iq_planar``'s arithmetic: f32,
    one rounding to ``dtype``."""
    iq = packed.contiguous().view(torch.uint8).unflatten(-1, (-1, 2))
    x = (iq.to(torch.float32) - IQ_CENTER) / IQ_SCALE
    return x.to(dtype).movedim(-1, 0).contiguous()


def iq_bytes_as_u16(raw: np.ndarray) -> np.ndarray:
    """Host-side zero-copy view of interleaved u8 I/Q bytes as packed
    uint16 words, one per sample (for ``u16_to_iq_planar``); the byte
    order is handled explicitly."""
    u16 = raw.view(np.uint16)
    if u16.dtype.byteorder == ">" or (
        u16.dtype.byteorder == "=" and not np.little_endian
    ):
        u16 = u16.byteswap()
    return u16


def iq_to_bytes(iq) -> np.ndarray:
    """Encode complex samples (numpy or torch) to interleaved u8 I/Q
    bytes: scale by 127.5, offset by 127.5, round half up, clamp to
    [0, 255] — the JAX encoder's rounding, not the Go tool's truncation."""
    iq = np.asarray(iq.cpu() if isinstance(iq, torch.Tensor) else iq)
    comps = np.stack([iq.real, iq.imag], axis=-1).astype(np.float32)
    scaled = comps * np.float32(IQ_SCALE) + np.float32(IQ_CENTER)
    return (
        np.clip(np.floor(scaled + np.float32(0.5)), 0.0, 255.0)
        .astype(np.uint8)
        .reshape(-1)
    )


def split_blocks(x: torch.Tensor):
    """Split a capture ``[2, 3n(+tail)]`` (or complex ``[3n]``) into its
    three equal blocks (ref1, tgt, ref2); trailing samples are dropped."""
    n = x.shape[-1] // NUM_BLOCKS
    return x[..., :n], x[..., n:2 * n], x[..., 2 * n:3 * n]


@dataclasses.dataclass
class DatCapture:
    """A decoded capture: device-resident planar blocks plus metadata."""

    ref1: torch.Tensor  # [2, L] first reference-frequency block
    tgt: torch.Tensor  # [2, L] target-frequency block
    ref2: torch.Tensor  # [2, L] second reference-frequency block
    path: str = ""
    station: str = ""


def load_dat(path: str, station: str = "",
             dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None,
             diag: Optional[dict] = None) -> DatCapture:
    """Load a ``.dat`` file and decode it on ``device`` (default: the
    card, ``utils.platform.default_device``) into planar ``dtype``
    blocks. Only whole ``3 × (I, Q)`` sample groups are kept.

    ``diag``, when given, gains (added to what it holds): ``read_s``,
    the host clock around the file read; ``h2d_s``, the host clock
    around the pageable copy to ``device``, which returns once the copy
    is done; ``h2d_bytes``, the bytes copied to the card (0 on the
    CPU)."""
    if device is None:
        device = default_device()
    t0 = time.perf_counter()
    raw = np.fromfile(path, dtype=np.uint8)
    t1 = time.perf_counter()
    usable = (raw.size // (2 * NUM_BLOCKS)) * (2 * NUM_BLOCKS)
    dev_raw = torch.from_numpy(raw[:usable]).to(device)
    if diag is not None:
        t2 = time.perf_counter()
        diag["read_s"] = diag.get("read_s", 0.0) + (t1 - t0)
        diag["h2d_s"] = diag.get("h2d_s", 0.0) + (t2 - t1)
        diag["h2d_bytes"] = diag.get("h2d_bytes", 0) + (
            usable if dev_raw.is_cuda else 0)
    iq = bytes_to_iq_planar(dev_raw, dtype)
    ref1, tgt, ref2 = split_blocks(iq)
    return DatCapture(ref1=ref1, tgt=tgt, ref2=ref2, path=path,
                      station=station)


def save_dat(path: str, ref1, tgt, ref2) -> int:
    """Write three complex blocks as a byte-contract ``.dat`` file and
    return the number of bytes written. Blocks must be equal length."""
    if not (len(ref1) == len(tgt) == len(ref2)):
        raise ValueError("all three blocks must have equal length")
    with open(path, "wb") as f:
        for b in (ref1, tgt, ref2):
            f.write(iq_to_bytes(b).tobytes())
    return os.path.getsize(path)
