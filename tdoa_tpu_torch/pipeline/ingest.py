"""Overlapped capture ingest: the file read, the host→card copy and the
streaming accumulator pipelined chunk by chunk.

Torch port of ``tdoa_tpu.pipeline.ingest``. The batch path
(``TDOAProcessor.process_files``) is read-THEN-copy-THEN-compute: every
file is read and copied whole before the first segment is correlated.
This module streams the capture in chunks of whole segments instead:

    host:          gather chunk k+1's rows from the mmaps into a pinned
                   buffer (this is also the file read)
    copy stream:   chunk k, pinned buffer → staging buffer on the card
    compute stream: decode chunk k−1 to planar samples, accumulate it
                   (kernel 1 on the kernel geometry)

Events order copy → decode → accumulate and guard the reuse of each
buffer; nothing synchronises the host with the card's compute stream
between the first chunk and the finalize. The pinned and staging buffers
are allocated once per call (once per ``TailIngest`` session). On a CPU
device the same chunk loop runs without pinned memory and streams.

Built on the checkpointable accumulator (``pipeline/streaming.py``).
``ingest_overlapped`` updates the three logical blocks at once by
stacking the [REF1|TGT|REF2] slices of every station into one
``[3·n_st, chunk]`` signal with per-block pair offsets — one kernel
launch per chunk, the batch pipeline's layout; ``TailIngest`` follows
files that are still growing with one accumulator per block. DC removal
is per chunk (the streaming counterpart of the batch path's per-block
mean subtraction). The finalize is the accumulator's estimator ladder and
the dual-REF clock correction of ``process_blocks``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdoa_tpu_torch.io.datfile import u16_to_iq_planar
from tdoa_tpu_torch.ops.corr import (
    TARGET_SEGS,
    auto_seg_len,
    clock_correct_blocks,
    resolve_seg,
)
from tdoa_tpu_torch.pipeline.streaming import (
    AccState,
    acc_finalize,
    acc_init,
    acc_update,
    kernel_geometry,
)
from tdoa_tpu_torch.utils.constants import DEFAULT_MAX_LAG
from tdoa_tpu_torch.utils.platform import default_device

# Segments per chunk when the caller names no chunk size: the smallest of
# 12, 24, 48, 96 and 192 whose capture→fix on the H100 was within the
# runs' own spread of the best (``PERF.md`` §5 has the table; each chunk
# costs the host about a millisecond of launches, whatever its size).
DEFAULT_CHUNK_SEGS = 96
# Pinned/staging buffer pairs in flight: one being gathered into, one on
# the copy stream, one being decoded.
STAGE_DEPTH = 3


def plan_chunks(
    block_len: int, seg_len: int, chunk_samples: Optional[int] = None
) -> Tuple[int, List[Tuple[int, int]]]:
    """Chunk layout for one block axis: (chunk, [(start, length), ...]).

    Every chunk length is a multiple of ``seg_len`` (the accumulator's
    contract); the ragged tail past the last whole segment is dropped,
    exactly like the batch correlator's segmentation. A smaller final
    chunk keeps every whole segment in play. ``chunk_samples=None``
    takes ``DEFAULT_CHUNK_SEGS`` segments.
    """
    if chunk_samples is None:
        chunk_samples = DEFAULT_CHUNK_SEGS * seg_len
    chunk = max(chunk_samples // seg_len, 1) * seg_len
    usable = (block_len // seg_len) * seg_len
    spans = []
    pos = 0
    while pos < usable:
        n = min(chunk, usable - pos)
        n = (n // seg_len) * seg_len
        if n == 0:
            break
        spans.append((pos, n))
        pos += n
    return chunk, spans


def _geometry(n_rows: int, n_pairs: int, block_len: int, max_lag: int,
              seg_len: Optional[int], accumulator: str,
              device: torch.device):
    """(seg_len, fft_len, dtype) of a streamed accumulation over
    ``n_rows`` channels: kernel 1's geometry with bf16 operands when the
    lag window, the block length (``TARGET_SEGS`` kernel segments, the
    batch route's rule: ``TDOAProcessor._fused_eligible``) and the
    kernel's single-bank footprint on ``device`` allow it and
    ``accumulator`` is not ``"xla"``, else the segmented geometry
    (``resolve_seg``) in f32 — for a short block the batch route's
    segmented geometry (``auto_seg_len``) unless ``"xla"`` asks for the
    reference's streaming geometry. ``"pallas"``, the reference's name
    for the kernel route, reads as ``"auto"``."""
    from tdoa_tpu_torch.ops.kernels.corr_accum import FFT_LEN, SEG_LEN

    if accumulator not in ("auto", "pallas", "xla"):
        raise ValueError(
            f"accumulator must be 'auto', 'pallas' or 'xla', got "
            f"{accumulator!r}")
    want = seg_len if seg_len is not None else 1 << 16
    if accumulator != "xla" and max_lag <= FFT_LEN - SEG_LEN:
        if (block_len >= TARGET_SEGS * SEG_LEN
                and kernel_geometry(n_rows, n_pairs, SEG_LEN, FFT_LEN,
                                    block_len, True, device)):
            return SEG_LEN, FFT_LEN, torch.bfloat16
        want = auto_seg_len(block_len, max_lag, want)
    seg, fft_len = resolve_seg(block_len, max_lag, want, None)
    return seg, fft_len, torch.float32


class _Stager:
    """Carries ``[rows, length]`` packed-u16 chunks from host views to
    ``device``. On CUDA: ``STAGE_DEPTH`` pinned host buffers and as many
    staging buffers on the card, a copy stream, and per buffer one event
    for "the copy out of the pinned buffer has finished" (waited for by
    the host before it gathers into that buffer again, and by the compute
    stream before it decodes) and one for "the decode that read the
    staging buffer has finished" (waited for by the copy stream before it
    overwrites it). On the CPU a chunk is a stacked numpy array."""

    def __init__(self, rows: int, chunk: int, device: torch.device):
        self.device = device
        self.gather_s = 0.0  # host clock around the (synchronous) gathers
        self._timed: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._k = 0
        if device.type != "cuda":
            return
        n = rows * chunk
        self._pinned = [torch.empty(n, dtype=torch.uint16, pin_memory=True)
                        for _ in range(STAGE_DEPTH)]
        self._host = [p.numpy() for p in self._pinned]
        self._staged = [torch.empty(n, dtype=torch.uint16, device=device)
                        for _ in range(STAGE_DEPTH)]
        self._copy_stream = torch.cuda.Stream(device)
        self._copied: List[Optional[torch.cuda.Event]] = [None] * STAGE_DEPTH
        self._decoded: List[Optional[torch.cuda.Event]] = [None] * STAGE_DEPTH

    def stage(self, views: Sequence[np.ndarray]) -> torch.Tensor:
        """The chunk whose rows are ``views`` (equal-length u16 slices of
        the host captures) as a ``[rows, length]`` tensor on the device,
        ordered after its copy on the current stream. Call ``decoded``
        once the ops that read it are enqueued."""
        rows, length = len(views), int(views[0].shape[0])
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = torch.from_numpy(np.stack(views))
            self.gather_s += time.perf_counter() - t0
            return out
        s = self._k % STAGE_DEPTH
        if self._copied[s] is not None:
            self._copied[s].synchronize()  # the copy stream only
        t0 = time.perf_counter()
        host = self._host[s][:rows * length].reshape(rows, length)
        for r, v in enumerate(views):
            np.copyto(host[r], v)
        self.gather_s += time.perf_counter() - t0
        src = self._pinned[s][:rows * length]
        dst = self._staged[s][:rows * length]
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if self._decoded[s] is not None:
            self._copy_stream.wait_event(self._decoded[s])
        with torch.cuda.stream(self._copy_stream):
            begin.record()
            dst.copy_(src, non_blocking=True)
            end.record()
        self._copied[s] = end
        self._timed.append((begin, end))
        torch.cuda.current_stream(self.device).wait_event(end)
        return dst.view(rows, length)

    def decoded(self) -> None:
        """Mark the staged chunk as read by everything enqueued so far on
        the current stream; its staging buffer may then be overwritten."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._decoded[self._k % STAGE_DEPTH] = ev
        self._k += 1

    def copy_seconds(self) -> Optional[float]:
        """Time the chunks spent on the copy stream, summed from CUDA
        events (waits for the last copy, not for the compute stream);
        ``None`` on the CPU, where there is no copy."""
        if self.device.type != "cuda":
            return None
        if self._timed:
            self._timed[-1][1].synchronize()
        return sum(b.elapsed_time(e) for b, e in self._timed) * 1e-3


def _decode_update(state: AccState, packed: torch.Tensor, pairs,
                   seg_len: int, fft_len: int,
                   dtype: torch.dtype) -> AccState:
    """Decode one staged chunk to planar ``dtype`` on its device and
    integrate it with per-chunk DC removal."""
    return acc_update(state, u16_to_iq_planar(packed, dtype=dtype), pairs,
                      seg_len, fft_len, remove_dc=True)


class TailIngest:
    """Incremental overlapped ingest of a GROWING capture window — the
    stream service's counterpart of ``ingest_overlapped``.

    A collection takes 10–100 s to write its ``.dat`` files;
    ``ingest_overlapped`` (and the batch path) only start after the last
    byte lands. This session consumes the files WHILE they grow: each
    ``feed`` call streams every newly-available chunk to the device, so
    by the time the writers close, only the final chunks and the finalize
    remain.

    Differences from ``ingest_overlapped``'s layout, chosen for
    tail-following: three per-block accumulators instead of one stacked
    [REF1|TGT|REF2] state. A stacked chunk needs the same within-block
    offset in all three blocks — available only once the file is 2/3
    written — while per-block states stream block 1 during its own
    capture. Per block the accumulated math is identical (same spans,
    same per-chunk slot rotation, same per-chunk DC removal), so the
    finalize reproduces ``ingest_overlapped`` / ``process_blocks``
    numerics to the usual streaming tolerance.

    Chunk readiness: chunk ``(b, start, len)`` needs samples up to
    ``b·capture_block_len + start + len`` in EVERY station's file
    (stations capture in lockstep, so availability tracks the slowest
    writer). ``block_len`` — the final per-block sample count — must be
    known up front (the service knows the collection duration); a station
    whose finished file disagrees invalidates the session (``mismatch``),
    and the caller falls back to the batch path. The chunks are planned
    once; nothing re-plans them from link rates.
    """

    def __init__(
        self,
        station_names: Sequence[str],
        pair_idx: np.ndarray,  # [m, 2]
        ref_geo_tdoa: np.ndarray,  # [m] samples
        *,
        block_len: int,
        capture_block_len: Optional[int] = None,
        max_lag: int = DEFAULT_MAX_LAG,
        seg_len: Optional[int] = None,
        weighting: str = "ht",
        clock_correction: bool = True,
        chunk_samples: Optional[int] = None,
        accumulator: str = "auto",
        device: Optional[torch.device] = None,
    ):
        self.names = list(station_names)
        n_st = len(self.names)
        self.device = (default_device() if device is None
                       else torch.device(device))
        self.block_len = int(block_len)
        # Files' actual per-block length (>= the ANALYZED block_len,
        # e.g. under truncate_samples): block b of every station sits
        # at b·capture_block_len regardless of how much is analyzed.
        self.capture_block_len = int(
            capture_block_len if capture_block_len is not None
            else block_len
        )
        if self.capture_block_len < self.block_len:
            raise ValueError(
                "capture_block_len must be >= the analyzed block_len"
            )
        self.max_lag = max_lag
        self.weighting = weighting
        self.clock_correction = clock_correction
        self._pairs = np.asarray(pair_idx, np.int32).reshape(-1, 2)
        self._m = int(self._pairs.shape[0])
        self._ref_geo = np.asarray(ref_geo_tdoa)
        # Per-block geometry: the kernel's gate sees (n_st, m), not the
        # stacked (3·n_st, 3·m) — strictly more permissive.
        self._seg, self._fft_len, self._dtype = _geometry(
            n_st, self._m, self.block_len, max_lag, seg_len, accumulator,
            self.device)
        chunk, spans = plan_chunks(self.block_len, self._seg, chunk_samples)
        if not spans:
            raise ValueError(
                f"block length {self.block_len} holds no whole segment "
                f"(seg_len={self._seg})"
            )
        self._chunk = chunk
        # Capture-order chunk plan: (block, start, length).
        self._plan: List[Tuple[int, int, int]] = [
            (b, s, l) for b in range(3) for (s, l) in spans
        ]
        self.link_diag: dict = {
            "adaptive": False,
            "chunk_segs": chunk // self._seg,
        }
        self._states = [
            acc_init(n_st, self._m, self._fft_len, self.device)
            for _ in range(3)
        ]
        self._stager: Optional[_Stager] = None  # buffers: at the first feed
        self._next = 0  # cursor over the plan, capture order
        self.mismatch: Optional[str] = None

    @property
    def total_chunks(self) -> int:
        return len(self._plan)

    @property
    def chunks_dispatched(self) -> int:
        return self._next

    @property
    def complete(self) -> bool:
        return self._next >= self.total_chunks

    def feed(self, host_u16: Sequence[np.ndarray]) -> int:
        """Stream every chunk whose samples all stations already have.

        ``host_u16`` are the stations' CURRENT packed-u16 views (in
        ``station_names`` order) — re-mmap growing files before each
        call; short views simply mean fewer ready chunks. Returns the
        number of chunks dispatched by this call. On the card the
        dispatches are asynchronous: its work overlaps the host's next
        poll and read."""
        avail = min(int(v.shape[0]) for v in host_u16)
        done = 0
        while self._next < self.total_chunks:
            b, start, length = self._plan[self._next]
            off = b * self.capture_block_len + start
            if avail < off + length:
                break
            if self._stager is None:
                self._stager = _Stager(len(self.names), self._chunk,
                                       self.device)
            buf = self._stager.stage([v[off:off + length] for v in host_u16])
            self._states[b] = _decode_update(
                self._states[b], buf, self._pairs, self._seg, self._fft_len,
                self._dtype)
            self._stager.decoded()
            self._next += 1
            done += 1
        return done

    def check_final_sizes(self, final_u16: Sequence[int]) -> bool:
        """Validate the finished files against the session's assumed
        block length: each station's ACTUAL per-block sample count
        (``final // 3``, the .dat contract's 3 equal blocks) must equal
        the session's — a shorter file means block-1/2 chunks were
        never readable, and a LONGER file means its real block
        boundaries sit past the assumed ones, so every block-1/2 chunk
        the session streamed mixed two blocks. Sets ``mismatch`` and
        returns False on violation — the caller must discard the
        session and batch-process the window instead."""
        for name, n in zip(self.names, final_u16):
            if int(n) // 3 != self.capture_block_len:
                self.mismatch = (
                    f"{name}: final capture holds {int(n) // 3} samples"
                    f"/block, session assumed {self.capture_block_len}"
                )
                return False
        return True

    def finalize(self, host_u16: Sequence[np.ndarray]):
        """Drain any remaining chunks from the (now complete) views and
        produce the ``process_blocks`` 10-tuple. Raises ``ValueError``
        while the capture is incomplete."""
        self.feed(host_u16)
        if not self.complete:
            _, start, length = self._plan[-1]
            raise ValueError(
                f"capture incomplete: {self._next}/{self.total_chunks} "
                f"chunks available (the last chunk needs "
                f"{2 * self.capture_block_len + start + length} "
                f"samples per station)"
            )
        if self._stager is not None:
            self.link_diag["gather_s"] = self._stager.gather_s
            self.link_diag["transfer_stream_s"] = self._stager.copy_seconds()
            self._stager = None  # release the pinned and staging buffers
        res = [
            acc_finalize(self._states[b], self._pairs, self.max_lag,
                         weighting=self.weighting, fft_len=self._fft_len)
            for b in range(3)
        ]

        def stk(field):
            return torch.stack([getattr(r, field) for r in res])

        return clock_correct_blocks(
            stk("delay"), stk("delay_std"), stk("quality"),
            stk("peak_value"), stk("corr"), stk("corr_c"),
            torch.as_tensor(self._ref_geo, dtype=torch.float32).to(
                self.device),
            self.clock_correction,
        )


def accumulate_overlapped(
    host_u16: Sequence[np.ndarray],  # per station: [3·block_len] packed u16
    pair_idx: np.ndarray,  # [m, 2] station pairs
    *,
    block_len: int,
    block_lens: Optional[Sequence[int]] = None,
    max_lag: int = DEFAULT_MAX_LAG,
    seg_len: Optional[int] = None,
    chunk_samples: Optional[int] = None,
    diag: Optional[dict] = None,
    accumulator: str = "auto",
    device: Optional[torch.device] = None,
) -> Tuple[AccState, np.ndarray, int]:
    """The streaming half of ``ingest_overlapped``: every chunk of the
    capture gathered, copied, decoded and integrated into ONE stacked
    accumulator over the three blocks. Returns ``(state, all_pairs,
    fft_len)``: the ``[3·n_st]``-channel state on ``device``, its pair
    list (each block's pairs offset into the stacked channel axis) and
    the FFT length — what ``acc_finalize``/``acc_save`` take. On the card
    nothing here waits for the compute stream (``diag`` waits for the
    last copy)."""
    dev = default_device() if device is None else torch.device(device)
    n_st = len(host_u16)
    if block_lens is None:
        block_lens = [block_len] * n_st
    if min(block_lens) < block_len:
        raise ValueError("block_lens must each be >= the analyzed "
                         "block_len")
    pair_np = np.asarray(pair_idx, np.int32).reshape(-1, 2)
    m = int(pair_np.shape[0])
    seg_r, fft_len, dtype = _geometry(
        3 * n_st, 3 * m, block_len, max_lag, seg_len, accumulator, dev)

    # Stacked pair list over the 3 logical blocks.
    offsets = np.arange(3, dtype=np.int32)[:, None, None] * n_st
    all_pairs = (pair_np[None, :, :] + offsets).reshape(3 * m, 2)

    chunk, spans = plan_chunks(block_len, seg_r, chunk_samples)
    if not spans:
        raise ValueError(
            f"block length {block_len} holds no whole segment "
            f"(seg_len={seg_r})"
        )

    def chunk_rows(start: int, length: int) -> List[np.ndarray]:
        """3·n_st u16 slices: every station's three block slices at the
        same within-block offset."""
        return [
            host_u16[s][b * block_lens[s] + start:
                        b * block_lens[s] + start + length]
            for b in range(3) for s in range(n_st)
        ]

    stager = _Stager(3 * n_st, chunk, dev)
    state = acc_init(3 * n_st, 3 * m, fft_len, dev)
    for start, length in spans:
        buf = stager.stage(chunk_rows(start, length))
        state = _decode_update(state, buf, all_pairs, seg_r, fft_len, dtype)
        stager.decoded()
    if diag is not None:
        diag.update(
            adaptive=False, mode="chunked", chunk_segs=chunk // seg_r,
            n_chunks=len(spans), gather_s=stager.gather_s,
            transfer_stream_s=stager.copy_seconds(),
        )
    return state, all_pairs, fft_len


def ingest_overlapped(
    host_u16: Sequence[np.ndarray],  # per station: [3·block_len] packed u16
    pair_idx: np.ndarray,  # [m, 2] station pairs
    ref_geo_tdoa: np.ndarray,  # [m] REF-tx geometric TDOA, samples
    *,
    block_len: int,
    block_lens: Optional[Sequence[int]] = None,
    max_lag: int = DEFAULT_MAX_LAG,
    seg_len: Optional[int] = None,
    weighting: str = "ht",
    clock_correction: bool = True,
    chunk_samples: Optional[int] = None,
    diag: Optional[dict] = None,
    accumulator: str = "auto",
    device: Optional[torch.device] = None,
):
    """Stream a 3-block capture from host memory to corrected TDOAs with
    the file read, the copy and the accumulation overlapped. Returns the
    same 10-tuple as ``process_blocks`` (corrected, tgt_delay,
    ref_delays[m,2], clock, quality[3,m], peaks[3,m], corrected_std,
    tgt_corr_window, tgt_std, block_corr_windows_complex[3,m,W]) on
    ``device`` (default: the card).

    ``host_u16`` is each station's packed-u16 view of its capture bytes
    (``io.datfile.iq_bytes_as_u16`` — zero-copy from the raw .dat mmap).
    ``block_len`` is the ANALYZED per-block sample count (common across
    stations); ``block_lens`` gives each station's own capture block
    length when files differ in size (its blocks sit at multiples of
    its own length), defaulting to ``block_len`` everywhere.

    ``chunk_samples`` sets the chunk size (default ``DEFAULT_CHUNK_SEGS``
    segments); the plan is fixed before the first chunk. ``diag``, when
    given, is filled with ``mode`` ("chunked"), ``chunk_segs``,
    ``n_chunks``, ``gather_s`` (host clock around the gathers into the
    staging memory, which are the file reads) and ``transfer_stream_s``
    (the chunks' time on the copy stream from CUDA events; ``None`` on the
    CPU); asking for it waits for the last copy.
    """
    dev = default_device() if device is None else torch.device(device)
    m = int(np.asarray(pair_idx).reshape(-1, 2).shape[0])
    state, all_pairs, fft_len = accumulate_overlapped(
        host_u16, pair_idx, block_len=block_len, block_lens=block_lens,
        max_lag=max_lag, seg_len=seg_len, chunk_samples=chunk_samples,
        diag=diag, accumulator=accumulator, device=dev)
    res = acc_finalize(state, all_pairs, max_lag, weighting=weighting,
                       fft_len=fft_len)
    return clock_correct_blocks(
        res.delay.reshape(3, m),
        res.delay_std.reshape(3, m),
        res.quality.reshape(3, m),
        res.peak_value.reshape(3, m),
        res.corr.reshape(3, m, -1),
        res.corr_c.reshape(3, m, -1),
        torch.as_tensor(np.asarray(ref_geo_tdoa), dtype=torch.float32).to(dev),
        clock_correction,
    )
