"""The batch ingest's chunked ring (``tdoa_tpu_torch/io/datfile.py``:
``_ChunkRing``, ``load_dat``, ``TDOAProcessor.load_files``).

A file's usable bytes pass through a few reused host buffers, a chunk at
a time, on their way to the buffer the decode reads. Whatever the chunk
size, the decoded blocks are bitwise those of the whole-file read
(``np.fromfile``, the usable bytes, ``bytes_to_iq_planar``,
``split_blocks``). The CPU tests run the ring on plain memory with small
chunks; the ``cuda`` tests run it pinned on the card. The file imports no
JAX, so its card tests run on a machine without it.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90  # noqa: F401
from tdoa_tpu_torch.io.datfile import (
    RING_CHUNK_BYTES,
    RING_SLOTS,
    _ChunkRing,
    bytes_to_iq_planar,
    load_dat,
    split_blocks,
)
from tdoa_tpu_torch.pipeline import TDOAProcessor

CSV = str(Path(__file__).resolve().parents[1] / "lat-lon-table.csv")
FREQS = (162_400_000.0, 101_900_000.0)
STATIONS = ("kx0u", "n3pay", "kf0mtl")
CHUNK = 4096  # bytes: a small chunk, so small files cross its edges
DTYPES = [torch.float32, torch.bfloat16]


def _dat(path, usable, extra=0, seed=0):
    """A .dat file of ``usable`` bytes of whole sample groups and
    ``extra`` bytes past them."""
    np.random.default_rng(seed).integers(
        0, 256, usable + extra, dtype=np.uint8).tofile(path)
    return str(path)


def _whole_read(path, dtype, device="cpu"):
    """The whole-file read the ring replaces: ``np.fromfile``, the
    usable bytes copied to ``device``, one decode there."""
    raw = np.fromfile(path, dtype=np.uint8)
    usable = (raw.size // 6) * 6
    return split_blocks(bytes_to_iq_planar(
        torch.from_numpy(raw[:usable]).to(device), dtype))


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.device == w.device and torch.equal(g, w)


def _blocks(cap):
    return cap.ref1, cap.tgt, cap.ref2


# (usable bytes, bytes past them): under one chunk; a chunk's multiple;
# not a multiple; one to five bytes past the usable ones; nothing usable.
SIZES = {
    "under-one-chunk": (6 * 100, 0),
    "whole-chunks": (3 * CHUNK, 0),
    "not-a-multiple": (6 * 1000, 0),
    "extra-1": (6 * 1500, 1),
    "extra-3": (6 * 1500, 3),
    "extra-5": (6 * 1501, 5),
    "nothing-usable": (0, 5),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("usable,extra", SIZES.values(), ids=SIZES.keys())
def test_ring_gives_the_whole_read_bitwise(tmp_path, usable, extra, dtype):
    path = _dat(tmp_path / "a.dat", usable, extra)
    ring = _ChunkRing("cpu", chunk_bytes=CHUNK)
    diag = {}
    cap = load_dat(path, dtype=dtype, device="cpu", diag=diag, ring=ring)
    _assert_bitwise(_blocks(cap), _whole_read(path, dtype))
    assert cap.ref1.shape == (2, usable // 6)
    assert diag["staged_chunks"] == math.ceil(usable / CHUNK)
    assert diag["pinned_allocs"] == 0 and diag["h2d_bytes"] == 0
    assert diag["h2d_s"] == 0.0 and diag["read_s"] >= 0.0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_ring_runs_on_from_a_smaller_file_to_a_larger(tmp_path, dtype):
    """One ring, two files: the second starts in the slot after the
    first's last, and both decode bitwise."""
    small = _dat(tmp_path / "s.dat", 6 * 1000, 2, seed=1)  # 2 chunks
    large = _dat(tmp_path / "l.dat", 6 * 4000, 4, seed=2)  # 6 chunks
    ring = _ChunkRing("cpu", chunk_bytes=CHUNK)
    diag = {}
    _assert_bitwise(_blocks(load_dat(small, dtype=dtype, device="cpu",
                                     diag=diag, ring=ring)),
                    _whole_read(small, dtype))
    assert ring.next == 2
    _assert_bitwise(_blocks(load_dat(large, dtype=dtype, device="cpu",
                                     diag=diag, ring=ring)),
                    _whole_read(large, dtype))
    assert ring.next == (2 + 6) % RING_SLOTS
    assert diag["staged_chunks"] == 2 + 6


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cpu_load_dat_reads_the_usable_bytes_straight(tmp_path, dtype):
    """Without a ring (the CPU's path) the bytes are read whole into the
    decode's buffer: nothing staged, nothing pinned."""
    path = _dat(tmp_path / "a.dat", 6 * 5000, 3)
    diag = {}
    _assert_bitwise(_blocks(load_dat(path, dtype=dtype, device="cpu",
                                     diag=diag)),
                    _whole_read(path, dtype))
    assert diag["staged_chunks"] == 0 and diag["pinned_allocs"] == 0


class _Trickle:
    """A file that gives at most ``step`` bytes a ``readinto``."""

    name = "trickle"

    def __init__(self, data, step):
        self.data, self.step, self.pos = data, step, 0

    def readinto(self, view):
        n = min(len(view), self.step, len(self.data) - self.pos)
        view[:n] = self.data[self.pos:self.pos + n]
        self.pos += n
        return n


def test_ring_fills_each_chunk_through_short_reads():
    data = np.random.default_rng(3).integers(0, 256, 10_000,
                                             dtype=np.uint8).tobytes()
    dst = torch.empty(len(data), dtype=torch.uint8)
    counts = _ChunkRing("cpu", chunk_bytes=CHUNK).stream(
        _Trickle(data, 1000), dst)
    assert dst.numpy().tobytes() == data
    assert counts["staged_chunks"] == 3


def test_a_file_that_ends_early_raises():
    dst = torch.empty(5000, dtype=torch.uint8)
    with pytest.raises(EOFError, match="trickle: ended 500 bytes early"):
        _ChunkRing("cpu", chunk_bytes=CHUNK).stream(
            _Trickle(bytes(4500), 700), dst)


def _station_files(tmp_path, usable, extra=3):
    return [_dat(tmp_path / f"{st}-1700000000.dat", usable, extra, seed=i)
            for i, st in enumerate(STATIONS)]


def test_cpu_load_files_keeps_no_ring(tmp_path):
    files = _station_files(tmp_path, 6 * 2000)
    proc = TDOAProcessor.from_csv(*FREQS, CSV, device="cpu")
    caps = proc.load_files(files)
    d = proc.ingest_diag
    assert proc._ring is None
    assert d["staged_chunks"] == 0 and d["pinned_allocs"] == 0
    for st, path in zip(STATIONS, files):
        _assert_bitwise(caps[st], _whole_read(path, caps[st][0].dtype))


@pytest.mark.cuda
def test_load_files_reuses_the_pinned_ring(cuda_sm90, tmp_path):
    """Two windows on one processor: the first makes the ring's pinned
    buffers, the second reuses them; both stage every chunk, send the
    usable bytes and decode bitwise what the whole-file read and its
    pageable copy decode on the card."""
    usable = 6 * 3_000_000  # 18 MB: two chunks a file
    files = _station_files(tmp_path, usable)
    proc = TDOAProcessor.from_csv(*FREQS, CSV, device=cuda_sm90)
    chunks = len(files) * math.ceil(usable / RING_CHUNK_BYTES)
    for allocs in (RING_SLOTS, 0):
        caps = proc.load_files(files)
        torch.cuda.synchronize()
        d = proc.ingest_diag
        assert d["pinned_allocs"] == allocs
        assert d["staged_chunks"] == chunks
        assert d["h2d_bytes"] == len(files) * usable
        assert d["read_s"] > 0.0 and d["h2d_s"] >= 0.0
        for st, path in zip(STATIONS, files):
            _assert_bitwise(caps[st], _whole_read(path, caps[st][0].dtype,
                                                  cuda_sm90))
    assert proc._ring.slots[0].is_pinned()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_load_dat_alone_on_the_card_makes_its_own_ring(cuda_sm90, tmp_path,
                                                       dtype):
    """A caller with no ring (the CLIs that load one file) gets one for
    the call. The blocks are bitwise the whole-file read's on the card,
    and in bf16 the CPU's too; in f32 the card's decode, which divides by
    the scale as a multiply by its reciprocal, differs from the CPU's by
    an ulp in half the byte values, with or without the ring."""
    usable = RING_CHUNK_BYTES * 2 + 6 * 7  # three chunks, the last short
    usable -= usable % 6
    path = _dat(tmp_path / "a.dat", usable, 5)
    diag = {}
    cap = load_dat(path, dtype=dtype, device=cuda_sm90, diag=diag)
    _assert_bitwise(_blocks(cap), _whole_read(path, dtype, cuda_sm90))
    if dtype == torch.bfloat16:
        cpu = load_dat(path, dtype=dtype, device="cpu")
        _assert_bitwise([b.cpu() for b in _blocks(cap)], _blocks(cpu))
    assert diag["pinned_allocs"] == RING_SLOTS
    assert diag["staged_chunks"] == math.ceil(usable / RING_CHUNK_BYTES)
    assert diag["h2d_bytes"] == usable

