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

import contextlib
import dataclasses
import os
import queue
import threading
import time
import weakref
from typing import Callable, List, Optional, Sequence

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


# The batch ingest's host ring on a card: a few reader threads, each with
# slots of pinned memory that the chunks it reads pass through on their
# way to the device.
RING_SLOTS = 2  # a reader's slots
RING_READERS = 4  # the most readers a ring makes
RING_CHUNK_BYTES = 16 << 20


def ring_readers() -> int:
    """The readers a ring makes on this host: one fewer than the CPUs
    this process may run on, at most ``RING_READERS``, at least 1."""
    return max(1, min(RING_READERS, len(os.sched_getaffinity(0)) - 1))


def _pread_exactly(fd: int, view: memoryview, offset: int, name: str,
                   total: int) -> None:
    """Fill ``view`` from the open file ``fd`` at ``offset``, which the
    caller expects to hold ``total`` bytes; reads at a position, so
    threads share no file position."""
    got = 0
    while got < len(view):
        n = os.preadv(fd, [view[got:]], offset + got)
        if not n:
            short = total - os.fstat(fd).st_size
            raise EOFError(f"{name}: ended {short} bytes early")
        got += n


def _covered(spans) -> float:
    """Seconds covered by the union of the ``(start, end)`` spans."""
    total, reach = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > reach:
            total += t1 - max(t0, reach)
            reach = t1
    return total


class _Window:
    """One ``_ChunkRing.stream`` call: its chunks ``(file, offset,
    bytes)`` in file order, handed to the readers one at a time as each
    frees up, and what the readers report back. Shared by the readers
    and the caller; every field after the chunks is guarded by
    ``cond``."""

    def __init__(self, files, chunk_bytes: int, stream):
        self.files = files  # [(fd, name, dst)], a file's dropped once read
        self.stream = stream  # the CUDA stream of the copies, or None
        self.chunks = [(i, off, min(chunk_bytes, dst.numel() - off))
                       for i, (_, _, dst) in enumerate(files)
                       for off in range(0, dst.numel(), chunk_bytes)]
        self.cond = threading.Condition()
        self.left = [0] * len(files)  # a file's chunks not yet copied
        for i, _, _ in self.chunks:
            self.left[i] += 1
        self.taken = 0
        self.stopped = False
        self.error: Optional[BaseException] = None
        self.running = 0  # readers still in this window
        self.readers = 0  # readers that read a chunk
        self.spans: list = []  # every read's (start, end), host clock
        self.waits = 0.0  # host seconds the readers waited for slots

    def take(self) -> Optional[int]:
        """The next chunk's index, or None when none is left to read."""
        with self.cond:
            if self.stopped or self.taken == len(self.chunks):
                return None
            self.taken += 1
            return self.taken - 1

    def copied(self, i: int) -> None:
        with self.cond:
            self.left[i] -= 1
            if not self.left[i]:
                self.cond.notify_all()

    def fail(self, e: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = e
            self.stopped = True
            self.cond.notify_all()

    def finish(self, spans, waits: float) -> None:
        with self.cond:
            self.spans += spans
            self.waits += waits
            self.readers += bool(spans)
            self.running -= 1
            self.cond.notify_all()

    def wait_file(self, i: int) -> None:
        """Wait until file ``i``'s copies are all enqueued; raise what a
        reader raised."""
        with self.cond:
            self.cond.wait_for(lambda: self.error is not None
                               or not self.left[i])
            if self.error is not None:
                raise self.error

    def end(self) -> None:
        """Hand out no more chunks and wait for every reader to leave."""
        with self.cond:
            self.stopped = True
            self.cond.wait_for(lambda: not self.running)


class _Reader:
    """One of a ring's reader threads and its slots. It reads the
    chunks it takes into its slots in turn, and copies each on to its
    place in the file's device buffer. On a card the slots are pinned,
    and each has an event, "this slot's last copy has finished", that
    the reader waits on before it reads into the slot again; elsewhere
    they are plain memory and a copy is done when it returns."""

    def __init__(self, device: torch.device, chunk_bytes: int, name: str):
        pinned = device.type == "cuda"
        self.slots = [torch.empty(chunk_bytes, dtype=torch.uint8,
                                  pin_memory=pinned)
                      for _ in range(RING_SLOTS)]
        self.views = [memoryview(s.numpy()) for s in self.slots]
        self.events = ([torch.cuda.Event() for _ in range(RING_SLOTS)]
                       if pinned else None)
        self.next = 0  # the slot the next chunk goes into
        self.inbox: queue.SimpleQueue = queue.SimpleQueue()
        self.thread = threading.Thread(target=self._run, name=name,
                                       daemon=True)
        self.thread.start()

    def wait(self, i: int) -> float:
        """Host seconds spent waiting for slot ``i``'s last copy. The
        event is asked first: a synchronize lets go of the interpreter
        lock, and taking it back while the other readers and the caller
        run takes longer than the copy, which has most often finished."""
        if self.events is None:
            return 0.0
        t0 = time.perf_counter()
        if not self.events[i].query():
            self.events[i].synchronize()
        return time.perf_counter() - t0

    def _run(self) -> None:
        while (window := self.inbox.get()) is not None:
            self._read(window)
            window = None  # hold no window's buffers while idle

    def _read(self, w: _Window) -> None:
        spans, waits = [], 0.0
        try:
            with (torch.cuda.stream(w.stream) if w.stream is not None
                  else contextlib.nullcontext()):
                while (k := w.take()) is not None:
                    i, off, n = w.chunks[k]
                    wait_s, span = self._chunk(w.files[i], off, n, w.stream)
                    waits += wait_s
                    spans.append(span)
                    w.copied(i)
        except Exception as e:  # raised again by the caller
            w.fail(e)
        finally:
            w.finish(spans, waits)

    def _chunk(self, file, off: int, n: int, stream):
        """Read ``n`` bytes at ``off`` of ``file``, ``(fd, name, dst)``,
        into the next slot once its last copy has finished, and enqueue
        their copy to ``dst``: (the host seconds waited for the slot,
        the read's (start, end))."""
        fd, name, dst = file
        s = self.next
        self.next = (s + 1) % RING_SLOTS
        wait_s = self.wait(s)
        t0 = time.perf_counter()
        _pread_exactly(fd, self.views[s][:n], off, name, dst.numel())
        span = (t0, time.perf_counter())
        dst[off:off + n].copy_(self.slots[s][:n], non_blocking=True)
        if self.events is not None:
            self.events[s].record(stream)
        return wait_s, span


def _stop_readers(readers) -> None:
    """End the reader threads, each once it is idle, and wait for them
    (unless called on one of them, by the collector): at the
    interpreter's exit they end before it finalizes."""
    for r in readers:
        r.inbox.put(None)
    for r in readers:
        if r.thread is not threading.current_thread():
            r.thread.join()


class _ChunkRing:
    """Reused host buffers that a window's files are read into chunk by
    chunk, by several reader threads at once, each chunk copied on to
    its place in a device buffer while the readers read the next ones.
    The readers, ``ring_readers()`` of them unless ``readers`` says
    otherwise, and their slots are made with the ring and kept for its
    life; ``close`` stops the readers."""

    def __init__(self, device, chunk_bytes: int = RING_CHUNK_BYTES,
                 readers: Optional[int] = None):
        self.device = torch.device(device)
        self.chunk_bytes = chunk_bytes
        self.readers = [
            _Reader(self.device, chunk_bytes, f"ring-reader-{k}")
            for k in range(readers or ring_readers())]
        # Pinned buffers made and not yet counted by ``stream``.
        self.allocs = (RING_SLOTS * len(self.readers)
                       if self.device.type == "cuda" else 0)
        self._stop = weakref.finalize(self, _stop_readers, self.readers)

    def stream(self, files,
               then: Optional[Callable[[int, torch.Tensor], None]] = None
               ) -> dict:
        """Read the first ``n`` bytes of each unbuffered file ``f`` of
        ``files``, ``[(f, n)]``, into a u8 buffer of its own on the
        ring's device, the chunks handed out in file order to the
        readers as they free up; on a card the copies go on the caller's
        current stream. Calls ``then(i, buffer)`` on the calling thread,
        in file order, once file ``i``'s copies are all enqueued, and
        holds the buffer no longer; raises what a reader raised, once
        every reader has left the window. Returns the counts of
        ``load_window``'s ``diag``, without ``h2d_bytes``."""
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        w = _Window([(f.fileno(), f.name,
                      torch.empty(n, dtype=torch.uint8, device=self.device))
                     for f, n in files], self.chunk_bytes, stream)
        active = self.readers[:len(w.chunks)]
        w.running = len(active)
        for r in active:
            r.inbox.put(w)
        try:
            for i in range(len(w.files)):
                w.wait_file(i)
                dst = w.files[i][2]
                w.files[i] = None  # no reader touches file i again
                if then is not None:
                    then(i, dst)
                del dst
        finally:
            w.end()
        counts = {"read_s": _covered(w.spans),
                  "read_busy_s": sum(t1 - t0 for t0, t1 in w.spans),
                  "readers": w.readers, "h2d_s": w.waits,
                  "staged_chunks": len(w.chunks),
                  "pinned_allocs": self.allocs}
        self.allocs = 0
        return counts

    def drain(self) -> float:
        """Host seconds spent waiting for every slot's last copy."""
        return sum(r.wait(i) for r in self.readers
                   for i in range(RING_SLOTS))

    def close(self) -> None:
        """Stop the readers and wait for them to end."""
        self._stop()


def _usable_bytes(fd: int) -> int:
    """The bytes of whole ``3 × (I, Q)`` sample groups in file ``fd``."""
    size = os.fstat(fd).st_size
    return size - size % (2 * NUM_BLOCKS)


def load_window(paths: Sequence[str], stations: Optional[Sequence[str]] = None,
                dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None,
                diag: Optional[dict] = None,
                ring: Optional[_ChunkRing] = None) -> List[DatCapture]:
    """Load a window's ``.dat`` files, each decoded on ``device``
    (default: the card, ``utils.platform.default_device``) into planar
    ``dtype`` blocks. Only whole ``3 × (I, Q)`` sample groups are read
    and kept.

    On a card the bytes pass through ``ring``, a ``_ChunkRing`` that a
    caller keeps across windows (one made for this call, and closed
    after it, when none is given): the ring's readers read the files'
    chunks at once, in file order, each chunk's copy to its file's
    device buffer overlapping the next reads; each file's decode is
    enqueued behind its copies as soon as they are all enqueued, and the
    host waits for the last copy at the end. On the CPU each file is
    read whole on the calling thread, straight into the buffer the
    decode reads, unless a ring is given.

    ``diag``, when given, gains (added to what it holds): ``read_s``,
    the host clock around the file reads (the time at least one read
    was in progress); ``read_busy_s``, the reads' own times summed over
    the readers (``read_busy_s / read_s``: the reads in progress at
    once); ``readers``, the threads that read a chunk (1 on the CPU's
    straight read where it read a byte); ``h2d_s``, the host clock
    spent waiting for copies to the card (for a ring slot's earlier copy
    and the last ones); ``h2d_bytes``, the bytes copied to the card (0
    on the CPU); ``staged_chunks``, the chunks that went through a ring;
    ``pinned_allocs``, the pinned buffers allocated."""
    if device is None:
        device = default_device()
    device = torch.device(device)
    stations = list(stations) if stations is not None else [""] * len(paths)
    caps: List[Optional[DatCapture]] = [None] * len(paths)
    own_ring = ring is None and device.type == "cuda"
    if own_ring:
        ring = _ChunkRing(device)
    try:
        with contextlib.ExitStack() as stack:
            opened = [stack.enter_context(open(p, "rb", buffering=0))
                      for p in paths]
            sizes = [_usable_bytes(f.fileno()) for f in opened]

            def decode(i: int, raw: torch.Tensor) -> None:
                ref1, tgt, ref2 = split_blocks(bytes_to_iq_planar(raw,
                                                                  dtype))
                caps[i] = DatCapture(ref1=ref1, tgt=tgt, ref2=ref2,
                                     path=paths[i], station=stations[i])

            if ring is not None:
                counts = ring.stream(list(zip(opened, sizes)), then=decode)
                counts["h2d_s"] += ring.drain()
            else:
                read_s = 0.0
                for i, (f, n) in enumerate(zip(opened, sizes)):
                    raw = torch.empty(n, dtype=torch.uint8, device=device)
                    t0 = time.perf_counter()
                    _pread_exactly(f.fileno(), memoryview(raw.numpy()), 0,
                                   f.name, n)
                    read_s += time.perf_counter() - t0
                    decode(i, raw)
                counts = {"read_s": read_s, "read_busy_s": read_s,
                          "readers": int(any(sizes)), "h2d_s": 0.0,
                          "staged_chunks": 0, "pinned_allocs": 0}
    finally:
        if own_ring:
            ring.close()
    if diag is not None:
        counts["h2d_bytes"] = sum(sizes) if device.type == "cuda" else 0
        for key, value in counts.items():
            diag[key] = diag.get(key, 0) + value
    return caps


def load_dat(path: str, station: str = "",
             dtype: torch.dtype = torch.float32,
             device: Optional[torch.device] = None,
             diag: Optional[dict] = None,
             ring: Optional[_ChunkRing] = None) -> DatCapture:
    """Load one ``.dat`` file: ``load_window`` of it alone (its
    ``diag``, and on a card a ring of this call's own, readers
    included, when none is given)."""
    return load_window([path], [station], dtype, device, diag, ring)[0]


def save_dat(path: str, ref1, tgt, ref2) -> int:
    """Write three complex blocks as a byte-contract ``.dat`` file and
    return the number of bytes written. Blocks must be equal length."""
    if not (len(ref1) == len(tgt) == len(ref2)):
        raise ValueError("all three blocks must have equal length")
    with open(path, "wb") as f:
        for b in (ref1, tgt, ref2):
            f.write(iq_to_bytes(b).tobytes())
    return os.path.getsize(path)
