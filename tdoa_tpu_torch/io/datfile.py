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


# The batch ingest's host ring on a card: slots of pinned memory that
# each file's bytes pass through on their way to the device.
RING_SLOTS = 3
RING_CHUNK_BYTES = 16 << 20


def _read_exactly(f, view: memoryview) -> None:
    """Fill ``view`` from the unbuffered file ``f``."""
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            raise EOFError(f"{f.name}: ended {len(view) - got} bytes early")
        got += n


class _ChunkRing:
    """Reused host buffers that files are read into chunk by chunk, each
    chunk copied on to its place in a device buffer while the next one
    is read. On a card the slots are pinned, and each has an event,
    "this slot's last copy has finished", that the host waits on before
    it reads into the slot again; elsewhere they are plain memory and a
    copy is done when it returns. The ring runs on from one file to the
    next without draining."""

    def __init__(self, device, chunk_bytes: int = RING_CHUNK_BYTES,
                 slots: int = RING_SLOTS):
        self.device = torch.device(device)
        pinned = self.device.type == "cuda"
        self.slots = [torch.empty(chunk_bytes, dtype=torch.uint8,
                                  pin_memory=pinned) for _ in range(slots)]
        self.views = [memoryview(s.numpy()) for s in self.slots]
        self.events = ([torch.cuda.Event() for _ in range(slots)]
                       if pinned else None)
        # Pinned buffers made and not yet counted by ``stream``.
        self.allocs = slots if pinned else 0
        self.next = 0

    def _wait(self, i: int) -> float:
        """Host seconds spent waiting for slot ``i``'s last copy."""
        if self.events is None:
            return 0.0
        t0 = time.perf_counter()
        self.events[i].synchronize()
        return time.perf_counter() - t0

    def stream(self, f, dst: torch.Tensor) -> dict:
        """Read ``dst.numel()`` bytes of the unbuffered file ``f`` into
        ``dst`` (u8) through the ring. Returns the counts of
        ``load_dat``'s ``diag``, without ``h2d_bytes``."""
        counts = {"read_s": 0.0, "h2d_s": 0.0, "staged_chunks": 0,
                  "pinned_allocs": self.allocs}
        self.allocs = 0
        cuda_stream = (torch.cuda.current_stream(self.device)
                       if self.events is not None else None)
        off, total = 0, dst.numel()
        while off < total:
            i = self.next
            self.next = (i + 1) % len(self.slots)
            counts["h2d_s"] += self._wait(i)
            n = min(len(self.views[i]), total - off)
            t0 = time.perf_counter()
            _read_exactly(f, self.views[i][:n])
            counts["read_s"] += time.perf_counter() - t0
            dst[off:off + n].copy_(self.slots[i][:n], non_blocking=True)
            if cuda_stream is not None:
                self.events[i].record(cuda_stream)
            off += n
            counts["staged_chunks"] += 1
        return counts

    def drain(self) -> float:
        """Host seconds spent waiting for every slot's last copy."""
        return sum(self._wait(i) for i in range(len(self.slots)))


def load_dat(path: str, station: str = "",
             dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None,
             diag: Optional[dict] = None,
             ring: Optional[_ChunkRing] = None) -> DatCapture:
    """Load a ``.dat`` file and decode it on ``device`` (default: the
    card, ``utils.platform.default_device``) into planar ``dtype``
    blocks. Only whole ``3 × (I, Q)`` sample groups are read and kept.

    On a card the bytes pass through ``ring``, a ``_ChunkRing`` that a
    caller keeps across files and windows (one made for this call when
    none is given): each chunk's copy to the device buffer overlaps the
    next chunk's read, and the decode is enqueued behind the last copy,
    so it overlaps whatever the host does next. On the CPU the bytes
    are read straight into the buffer the decode reads, unless a ring
    is given.

    ``diag``, when given, gains (added to what it holds): ``read_s``,
    the host clock around the file reads; ``h2d_s``, the host clock
    spent waiting for copies to the card (for a ring slot's earlier
    copy and, with a ring of this call's own, for the last one);
    ``h2d_bytes``, the bytes copied to the card (0 on the CPU);
    ``staged_chunks``, the chunks that went through a ring;
    ``pinned_allocs``, the pinned buffers allocated."""
    if device is None:
        device = default_device()
    device = torch.device(device)
    own_ring = ring is None and device.type == "cuda"
    if own_ring:
        ring = _ChunkRing(device)
    with open(path, "rb", buffering=0) as f:
        size = os.fstat(f.fileno()).st_size
        usable = (size // (2 * NUM_BLOCKS)) * (2 * NUM_BLOCKS)
        dev_raw = torch.empty(usable, dtype=torch.uint8, device=device)
        if ring is not None:
            counts = ring.stream(f, dev_raw)
        else:
            t0 = time.perf_counter()
            _read_exactly(f, memoryview(dev_raw.numpy()))
            counts = {"read_s": time.perf_counter() - t0, "h2d_s": 0.0,
                      "staged_chunks": 0, "pinned_allocs": 0}
    iq = bytes_to_iq_planar(dev_raw, dtype)
    ref1, tgt, ref2 = split_blocks(iq)
    if own_ring:
        counts["h2d_s"] += ring.drain()
    if diag is not None:
        counts["h2d_bytes"] = usable if dev_raw.is_cuda else 0
        for key, value in counts.items():
            diag[key] = diag.get(key, 0) + value
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
