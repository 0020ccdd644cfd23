"""The batch ingest's chunked ring (``tdoa_tpu_torch/io/datfile.py``:
``_ChunkRing``, ``load_window``, ``load_dat``,
``TDOAProcessor.load_files``).

A window's usable bytes are read a chunk at a time by the ring's reader
threads, several at once, each into reused host buffers of its own, on
their way to the buffers the decode reads. Whatever the chunk size and
the number of readers, the decoded blocks are bitwise those of the
whole-file read (``np.fromfile``, the usable bytes,
``bytes_to_iq_planar``, ``split_blocks``). The CPU tests run the ring on
plain memory with small chunks, each over 1, 2 and 4 readers; the
``cuda`` tests run it pinned on the card. The file imports no JAX, so
its card tests run on a machine without it.
"""

import contextlib
import math
import os
import sys
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90  # noqa: F401
from tdoa_tpu_torch.io import datfile
from tdoa_tpu_torch.io.datfile import (
    RING_CHUNK_BYTES,
    RING_SLOTS,
    _ChunkRing,
    bytes_to_iq_planar,
    load_dat,
    load_window,
    ring_readers,
    split_blocks,
)
from tdoa_tpu_torch.pipeline import TDOAProcessor

CSV = str(Path(__file__).resolve().parents[1] / "lat-lon-table.csv")
FREQS = (162_400_000.0, 101_900_000.0)
STATIONS = ("kx0u", "n3pay", "kf0mtl")
CHUNK = 4096  # bytes: a small chunk, so small files cross its edges
DTYPES = [torch.float32, torch.bfloat16]
READERS = [1, 2, 4]
TIMEOUT_S = 60  # far above any window here: a window that takes it hung


@pytest.fixture(params=READERS, ids=[f"{r}-readers" for r in READERS])
def ring(request):
    """A CPU ring of small chunks and 1, 2 or 4 readers, closed after."""
    r = _ChunkRing("cpu", chunk_bytes=CHUNK, readers=request.param)
    yield r
    r.close()
    assert not any(rd.thread.is_alive() for rd in r.readers)


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


def _bounded(fn):
    """``fn()`` on a thread of its own, which must end within
    ``TIMEOUT_S``: (its result, what it raised)."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except Exception as e:
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(TIMEOUT_S)
    assert not t.is_alive(), f"no end within {TIMEOUT_S} s"
    return out.get("value"), out.get("error")


def _assert_window_counts(diag, ring, chunks):
    """Every chunk staged; as many readers as read one, no more than
    the ring holds; the reads' summed time at least their union's."""
    assert diag["staged_chunks"] == chunks
    assert (1 if chunks else 0) <= diag["readers"]
    assert diag["readers"] <= min(len(ring.readers), chunks)
    assert diag["read_busy_s"] >= diag["read_s"] >= 0.0
    assert diag["pinned_allocs"] == 0 and diag["h2d_s"] == 0.0


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
def test_ring_gives_the_whole_read_bitwise(tmp_path, ring, usable, extra,
                                           dtype):
    path = _dat(tmp_path / "a.dat", usable, extra)
    diag = {}
    cap = load_dat(path, dtype=dtype, device="cpu", diag=diag, ring=ring)
    _assert_bitwise(_blocks(cap), _whole_read(path, dtype))
    assert cap.ref1.shape == (2, usable // 6)
    _assert_window_counts(diag, ring, math.ceil(usable / CHUNK))
    assert diag["h2d_bytes"] == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_ring_runs_on_from_a_smaller_file_to_a_larger(tmp_path, ring, dtype):
    """One ring, two calls: both decode bitwise through the same
    readers; one reader takes its slots in turn across the calls, the
    second call starting in the slot after the first's last."""
    small = _dat(tmp_path / "s.dat", 6 * 1000, 2, seed=1)  # 2 chunks
    large = _dat(tmp_path / "l.dat", 6 * 4000, 4, seed=2)  # 6 chunks
    threads = [r.thread for r in ring.readers]
    diag = {}
    _assert_bitwise(_blocks(load_dat(small, dtype=dtype, device="cpu",
                                     diag=diag, ring=ring)),
                    _whole_read(small, dtype))
    if len(ring.readers) == 1:
        assert ring.readers[0].next == 2 % RING_SLOTS
    _assert_bitwise(_blocks(load_dat(large, dtype=dtype, device="cpu",
                                     diag=diag, ring=ring)),
                    _whole_read(large, dtype))
    if len(ring.readers) == 1:
        assert ring.readers[0].next == (2 + 6) % RING_SLOTS
    assert diag["staged_chunks"] == 2 + 6
    assert [r.thread for r in ring.readers] == threads
    assert all(t.is_alive() for t in threads)


# Files of unequal sizes that CHUNK does not divide, each with bytes
# past its usable ones: 1, 5, 3, 2 and 12 chunks.
WINDOW = [(6 * 500, 1), (6 * 3001, 5), (6 * 2000, 3), (6 * 1200, 2),
          (6 * 8000, 4)]


def _window_files(tmp_path, sizes=WINDOW):
    return [_dat(tmp_path / f"w{i}.dat", usable, extra, seed=10 + i)
            for i, (usable, extra) in enumerate(sizes)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_window_of_unequal_files_gives_the_whole_reads_bitwise(
        tmp_path, ring, dtype):
    """A window's files, read at once by the ring's readers, come out
    in order, each bitwise the whole-file read; its counters are the
    window's."""
    paths = _window_files(tmp_path)
    diag = {}
    caps = load_window(paths, ["a", "b", "c", "d", "e"], dtype=dtype,
                       device="cpu", diag=diag, ring=ring)
    assert [c.path for c in caps] == paths
    assert [c.station for c in caps] == ["a", "b", "c", "d", "e"]
    for cap, path in zip(caps, paths):
        _assert_bitwise(_blocks(cap), _whole_read(path, dtype))
    _assert_window_counts(diag, ring, sum(math.ceil(u / CHUNK)
                                          for u, _ in WINDOW))


def test_readers_read_at_once(tmp_path, ring, monkeypatch):
    """Every reader held in its first read until all of them are in
    one (a barrier), each read a few ms long: ``readers`` counts each
    of them, and on more than one the summed reads exceed their union
    by half at least."""
    n = len(ring.readers)
    barrier = threading.Barrier(n, timeout=TIMEOUT_S)
    entered, lock = set(), threading.Lock()
    pread = os.preadv

    def held(fd, buffers, offset):
        with lock:
            first = threading.get_ident() not in entered
            entered.add(threading.get_ident())
        if first:
            barrier.wait()
        time.sleep(0.005)
        return pread(fd, buffers, offset)

    monkeypatch.setattr(os, "preadv", held)
    path = _dat(tmp_path / "a.dat", 16 * CHUNK - 6 * 11, 1)  # 16 chunks
    diag = {}
    cap, err = _bounded(lambda: load_dat(path, device="cpu", diag=diag,
                                         ring=ring))
    assert err is None
    _assert_bitwise(_blocks(cap), _whole_read(path, torch.float32))
    _assert_window_counts(diag, ring, 16)
    assert diag["readers"] == n
    if n > 1:
        assert diag["read_busy_s"] > 1.5 * diag["read_s"]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cpu_load_dat_reads_the_usable_bytes_straight(tmp_path, dtype):
    """Without a ring (the CPU's path) the bytes are read whole into the
    decode's buffer by the calling thread: nothing staged, nothing
    pinned."""
    path = _dat(tmp_path / "a.dat", 6 * 5000, 3)
    diag = {}
    _assert_bitwise(_blocks(load_dat(path, dtype=dtype, device="cpu",
                                     diag=diag)),
                    _whole_read(path, dtype))
    assert diag["staged_chunks"] == 0 and diag["pinned_allocs"] == 0
    assert diag["readers"] == 1 and diag["read_busy_s"] == diag["read_s"]


def test_ring_fills_each_chunk_through_short_reads(tmp_path, ring,
                                                   monkeypatch):
    """Reads that return at most 1000 bytes a call still fill every
    chunk."""
    pread, calls = os.preadv, []

    def short(fd, buffers, offset):
        calls.append(offset)
        return pread(fd, [buffers[0][:1000]], offset)

    monkeypatch.setattr(os, "preadv", short)
    data = np.random.default_rng(3).integers(0, 256, 10_000,
                                             dtype=np.uint8)
    path = tmp_path / "a.dat"
    data.tofile(path)
    got = []
    with open(path, "rb", buffering=0) as f:
        counts = ring.stream([(f, data.size)],
                             then=lambda i, raw: got.append((i, raw)))
    assert len(got) == 1 and got[0][0] == 0
    assert np.array_equal(got[0][1].numpy(), data)
    assert counts["staged_chunks"] == 3 and len(calls) == 5 + 5 + 2


def test_ring_holds_no_buffer_past_its_decode(tmp_path, ring):
    """Each file's buffer is the caller's alone once handed over: when
    the caller drops it, it is freed, in the window and after it (so a
    window's buffers do not pile up under its decodes)."""
    paths = _window_files(tmp_path)
    alive = []

    def then(i, raw):
        alive.append(weakref.ref(raw))
        assert all(r() is None for r in alive[:-1])

    with contextlib.ExitStack() as stack:
        files = [stack.enter_context(open(p, "rb", buffering=0))
                 for p in paths]
        ring.stream([(f, u) for f, (u, _) in zip(files, WINDOW)], then=then)
    assert len(alive) == len(paths)
    assert all(r() is None for r in alive)


def test_a_file_that_ends_early_raises(tmp_path, ring):
    """A file 500 bytes short of what its buffer asks raises from the
    reader that meets its end; the ring reads the next window."""
    path = str(tmp_path / "a.dat")
    Path(path).write_bytes(bytes(4500))
    with open(path, "rb", buffering=0) as f:
        _, err = _bounded(lambda: ring.stream([(f, 5000)]))
    assert isinstance(err, EOFError)
    assert str(err) == f"{path}: ended 500 bytes early"
    whole = _dat(tmp_path / "b.dat", 6 * 2000, 1, seed=4)
    _assert_bitwise(_blocks(load_dat(whole, device="cpu", ring=ring)),
                    _whole_read(whole, torch.float32))


def test_a_truncated_file_raises_from_load_dat_and_load_files(
        tmp_path, ring, monkeypatch):
    """A file whose size, when it was opened, said three chunks more
    than it holds (as if cut while the window read it) raises ``EOFError``
    from ``load_dat`` and from ``load_files`` on a processor holding
    the ring, with neither hanging; the same ring then loads the next
    window bitwise."""
    files = _station_files(tmp_path, 6 * 3000)  # 5 chunks each
    short = files[1]
    usable = datfile._usable_bytes

    def grown(fd):
        same = os.path.samestat(os.fstat(fd), os.stat(short))
        return usable(fd) + (3 * CHUNK if same else 0)

    monkeypatch.setattr(datfile, "_usable_bytes", grown)
    proc = TDOAProcessor.from_csv(*FREQS, CSV, device="cpu")
    proc._ring = ring
    for load in (lambda: load_dat(short, device="cpu", ring=ring),
                 lambda: proc.load_files(files)):
        _, err = _bounded(load)
        assert isinstance(err, EOFError)
        assert str(err) == f"{short}: ended {3 * CHUNK - 3} bytes early"
    monkeypatch.undo()
    caps, err = _bounded(lambda: proc.load_files(files))
    assert err is None
    for st, path in zip(STATIONS, files):
        _assert_bitwise(caps[st], _whole_read(path, caps[st][0].dtype))
    assert proc.ingest_diag["staged_chunks"] == 3 * 5


def test_many_readers_on_few_cores_lose_no_chunk(tmp_path):
    """More readers than cores, 64-byte chunks and the interpreter
    switching threads every microsecond: over five windows every chunk
    is counted once and every byte lands where it belongs."""
    readers = (os.cpu_count() or 1) + 2
    ring = _ChunkRing("cpu", chunk_bytes=64, readers=readers)
    sizes = [(6 * 500, 1), (6 * 77, 0), (6 * 1234, 5), (0, 3), (6 * 301, 2)]
    paths = _window_files(tmp_path, sizes)
    chunks = sum(math.ceil(u / 64) for u, _ in sizes)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            diag = {}
            caps, err = _bounded(lambda: load_window(
                paths, device="cpu", diag=diag, ring=ring))
            assert err is None
            for cap, path in zip(caps, paths):
                _assert_bitwise(_blocks(cap),
                                _whole_read(path, torch.float32))
            _assert_window_counts(diag, ring, chunks)
    finally:
        sys.setswitchinterval(interval)
        ring.close()
    assert not any(r.thread.is_alive() for r in ring.readers)


def test_ring_readers_follow_the_usable_cpus(monkeypatch):
    """One fewer than the CPUs this process may run on, at most
    ``RING_READERS``, at least 1."""
    for cpus, want in ((1, 1), (2, 1), (3, 2), (5, 4), (8, 4), (64, 4)):
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda pid, n=cpus: set(range(n)))
        assert ring_readers() == want


class _Event:
    """A copy's event that has or has not finished."""

    def __init__(self, done):
        self.done, self.synced = done, 0

    def query(self):
        return self.done

    def synchronize(self):
        self.synced += 1


@pytest.mark.parametrize("done", [True, False], ids=["finished", "pending"])
def test_a_reader_waits_only_for_a_copy_still_pending(ring, done):
    """A slot whose last copy has finished is reused without a
    synchronize (which would give up the interpreter lock); a pending
    one is waited for."""
    reader = ring.readers[0]
    reader.events = [_Event(done) for _ in range(RING_SLOTS)]
    assert reader.wait(0) >= 0.0
    assert reader.events[0].synced == (0 if done else 1)


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
    assert d["readers"] == 1
    for st, path in zip(STATIONS, files):
        _assert_bitwise(caps[st], _whole_read(path, caps[st][0].dtype))


@pytest.mark.cuda
def test_load_files_reuses_the_pinned_ring(cuda_sm90, tmp_path):
    """Two windows on one processor: the first makes the ring's reader
    threads and their pinned slots, the second reuses them and makes
    none; both read with two readers or more, stage every chunk, send
    the usable bytes and decode bitwise what the whole-file read and its
    pageable copy decode on the card, and what one reader's ring
    decodes."""
    usable = 6 * 3_000_000  # 18 MB: two chunks a file
    files = _station_files(tmp_path, usable)
    proc = TDOAProcessor.from_csv(*FREQS, CSV, device=cuda_sm90)
    chunks = len(files) * math.ceil(usable / RING_CHUNK_BYTES)
    one = _ChunkRing(cuda_sm90, readers=1)
    made = None
    for window in range(2):
        caps = proc.load_files(files)
        torch.cuda.synchronize()
        d = proc.ingest_diag
        ring = proc._ring
        now = ([r.thread for r in ring.readers],
               [s.data_ptr() for r in ring.readers for s in r.slots])
        made = made or now
        assert now == made and all(t.is_alive() for t in now[0])
        assert d["pinned_allocs"] == (RING_SLOTS * len(ring.readers)
                                      if window == 0 else 0)
        assert d["readers"] >= 2
        assert d["staged_chunks"] == chunks
        assert d["h2d_bytes"] == len(files) * usable
        assert d["read_busy_s"] >= d["read_s"] > 0.0 and d["h2d_s"] >= 0.0
        dtype = caps[STATIONS[0]][0].dtype
        singles = load_window(files, dtype=dtype, device=cuda_sm90,
                              ring=one)
        for st, path, single in zip(STATIONS, files, singles):
            _assert_bitwise(caps[st], _whole_read(path, dtype, cuda_sm90))
            _assert_bitwise(caps[st], _blocks(single))
    one.close()
    assert all(s.is_pinned() for r in proc._ring.readers for s in r.slots)
    assert len(proc._ring.readers) == ring_readers()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_load_dat_alone_on_the_card_makes_its_own_ring(cuda_sm90, tmp_path,
                                                       dtype):
    """A caller with no ring (the CLIs that load one file) gets one for
    the call, readers included, and its readers end with the call. The
    blocks are bitwise the whole-file read's on the card, and in bf16
    the CPU's too; in f32 the card's decode, which divides by the scale
    as a multiply by its reciprocal, differs from the CPU's by an ulp in
    half the byte values, with or without the ring."""
    usable = RING_CHUNK_BYTES * 2 + 6 * 7  # three chunks, the last short
    usable -= usable % 6
    path = _dat(tmp_path / "a.dat", usable, 5)
    before = threading.active_count()
    diag = {}
    cap = load_dat(path, dtype=dtype, device=cuda_sm90, diag=diag)
    assert threading.active_count() == before
    _assert_bitwise(_blocks(cap), _whole_read(path, dtype, cuda_sm90))
    if dtype == torch.bfloat16:
        cpu = load_dat(path, dtype=dtype, device="cpu")
        _assert_bitwise([b.cpu() for b in _blocks(cap)], _blocks(cpu))
    assert diag["pinned_allocs"] == RING_SLOTS * ring_readers()
    assert diag["staged_chunks"] == math.ceil(usable / RING_CHUNK_BYTES)
    assert diag["h2d_bytes"] == usable
