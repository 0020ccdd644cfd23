"""Tracing and stage timing of the port (``tdoa_tpu_torch/utils/
profiling.py``) and the processor's stage names, against the JAX
package's ``utils/profiling.py`` and processor on the same simulated
files (the port on CPU tensors).

The stage names a ``TDOAProcessor.timer`` sees are what ``--profile``
reports. The port names the reference's stages in the reference's order
(``load+decode``, ``mmap`` and ``re-solve (echo-bias σ)`` included) and
stages of its own between them, which cover the rest of the window:
``prepare``, ``checks``, ``multipath``, ``analyze``, ``assemble`` and
``unmap``. A window's stages follow one another, none inside another.
``TDOAProcessor.ingest_diag`` holds what the window's ingest did.
"""

import contextlib
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90, scene  # noqa: F401

try:  # the card's machine has no JAX: there only the `cuda` tests run
    from tdoa_tpu.cli import processor as jax_cli
    from tdoa_tpu.dsp import multipath as jmultipath
    from tdoa_tpu.pipeline import TDOAProcessor as JaxProcessor
    from tdoa_tpu.sim import write_scene_captures
    from tdoa_tpu.utils import profiling as jprof
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.cli import processor as port_cli
from tdoa_tpu_torch.dsp import multipath as tmultipath
from tdoa_tpu_torch.io.datfile import iq_bytes_as_u16, load_dat
from tdoa_tpu_torch.io.stations import station_from_filename
from tdoa_tpu_torch.pipeline import TDOAProcessor
from tdoa_tpu_torch.pipeline.processor import HostCapture
from tdoa_tpu_torch.utils import profiling as tprof

REPO = Path(__file__).resolve().parents[1]
CSV = str(REPO / "lat-lon-table.csv")
OMAHA = {
    "names": ("kx0u", "n3pay", "kf0mtl"),
    "station_lla": np.array([
        [41.18660274289527, -95.96064116595667, 355.69],
        [41.24669616513154, -96.08366304481238, 329.0],
        [41.32916620016985, -96.03513381562004, 373.18],
    ]),
    "ref_tx_lla": np.array([41.25703803095629, -95.95512763589404, 349.07]),
    "tgt_tx_lla": np.array([41.30888549464701, -96.02619229605524, 356.0]),
    "ref_freq": 162_400_000.0,
    "tgt_freq": 101_900_000.0,
}
FREQS = (OMAHA["ref_freq"], OMAHA["tgt_freq"])
SMALL = dict(seg_len=1 << 14, max_lag=512)


def test_stage_timer_report_format_equals_the_references():
    times = {"load+decode": 0.2034, "correlate+clock": 0.0412,
             "re-solve (echo-bias σ)": 0.0031, "solve": 0.0205}
    timers = [tprof.StageTimer(), jprof.StageTimer()]
    for t in timers:
        for name, sec in times.items():
            t.times[name] = sec
            t.order.append(name)
    assert timers[0].report() == timers[1].report()
    assert timers[0].report().splitlines()[0] == "total    268.2 ms"


def test_stage_timer_accumulates_in_first_seen_order():
    t = tprof.StageTimer()
    for name in ("a", "b", "a"):
        with t.stage(name):
            pass
    assert t.order == ["a", "b"]
    assert set(t.times) == {"a", "b"} and t.times["a"] >= 0.0
    with pytest.raises(KeyError):  # a stage that raises is still timed
        with t.stage("c"):
            raise KeyError("c")
    assert t.order == ["a", "b", "c"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "tr").glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 3 × 2¹⁷-sample scene with clock offsets, as ``.dat`` files."""
    sc = scene(OMAHA, 1 << 17, seed=11,
               clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]))
    out = tmp_path_factory.mktemp("profiling")
    paths, _ = write_scene_captures(sc, str(out))
    return sorted(paths.values())


@pytest.fixture
def no_echo_sigma(monkeypatch):
    """Both packages' echo-bias σ forced to zero: no re-solve."""
    def sigma(offset, env_confirmed=False):
        return np.zeros(np.shape(offset))

    monkeypatch.setattr(jmultipath, "echo_bias_sigma", sigma)
    monkeypatch.setattr(tmultipath, "echo_bias_sigma", sigma)


# The port's stages of a window on the files' scene, in first-seen order.
_FRONT = {"process_files": ["load+decode", "prepare", "correlate+clock"],
          "process_files_overlapped": ["mmap", "prepare",
                                       "ingest+correlate+clock"]}
_ECHO = ["multipath", "re-solve (echo-bias σ)"]
_BACK = ["analyze", "assemble"]
FM = dict(mode="fm", fm_decim=8)


def _expected(run, echo, fm=False):
    mid = [] if fm else _ECHO if echo else _ECHO[:1]
    tail = ["unmap"] if run.endswith("overlapped") else []
    return _FRONT[run] + ["checks", "solve"] + mid + _BACK + tail


def _in_order(sub, seq):
    """Whether ``sub`` is an ordered subsequence of ``seq``."""
    it = iter(seq)
    return all(x in it for x in sub)


@pytest.mark.parametrize("run,echo,fm", [
    ("process_files", True, False),
    ("process_files_overlapped", True, False),
    ("process_files", False, False),
    ("process_files_overlapped", False, False),
    ("process_files", False, True),
], ids=["files", "overlapped", "files-no-echo", "overlapped-no-echo", "fm"])
def test_stage_names_equal_the_references(files, request, run, echo, fm):
    """On this scene both packages add an echo-bias σ and solve again
    (``re-solve (echo-bias σ)``); with that σ forced to zero neither
    does, and FM mode runs no echo accounting. The reference's stages
    appear in its order among the port's, which are the expected list."""
    if not echo and not fm:
        request.getfixturevalue("no_echo_sigma")
    kw = {**SMALL, **(FM if fm else {})}
    jp = JaxProcessor.from_csv(*FREQS, CSV, **kw)
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device="cpu", **kw)
    jp.timer, tp.timer = jprof.StageTimer(), tprof.StageTimer()
    getattr(jp, run)(files)
    getattr(tp, run)(files)
    assert _in_order(jp.timer.order, tp.timer.order)
    assert tp.timer.order == _expected(run, echo, fm)
    assert ("re-solve (echo-bias σ)" in jp.timer.order) is echo


class _Intervals:
    """A timer that keeps each stage's interval and how many stages were
    open when it opened."""

    def __init__(self):
        self.spans, self.depths, self._open = [], [], 0

    @contextlib.contextmanager
    def stage(self, name):
        self.depths.append(self._open)
        self._open += 1
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.perf_counter_ns(), name))
            self._open -= 1


def _tail_window(proc, paths):
    """A tail session fed the whole files, then its window."""
    known = proc.stations.names
    views = {}
    for p in paths:
        raw = np.memmap(p, dtype=np.uint8, mode="r")
        views[station_from_filename(p, known)] = iq_bytes_as_u16(
            raw[: (raw.size // 2) * 2])
    names = sorted(views)
    bl = views[names[0]].shape[0] // 3
    sess = proc.tail_session(names, bl, chunk_samples=bl // 4)
    sess.feed([views[n] for n in names])
    caps = {n: HostCapture(u16=views[n], block_len=bl) for n in names}
    return proc.process_captures(caps, tail=sess), sess


_PATHS = {
    "files": (lambda p, f: p.process_files(f), {}),
    "overlapped": (lambda p, f: p.process_files_overlapped(f), {}),
    "fm": (lambda p, f: p.process_files(f), FM),
    "tail": (_tail_window, {"accumulator": "xla"}),
    "lo-velocity-emitters": (lambda p, f: p.process_files(f),
                             {"lo_compensation": "auto",
                              "solve_velocity": True, "multi_emitter": 2}),
}


@pytest.mark.parametrize("path", list(_PATHS))
def test_no_stage_opens_inside_another(files, path):
    """Each stage opens with no other open, and the intervals of a
    window's stages are disjoint."""
    call, kw = _PATHS[path]
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device="cpu", **SMALL, **kw)
    tp.timer = _Intervals()
    call(tp, files)
    spans = sorted(tp.timer.spans)
    assert len(spans) >= 6 and set(tp.timer.depths) == {0}
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        assert end <= start, f"{b} opened before {a} ended"


@pytest.mark.parametrize("path", ["files", "overlapped", "fm"])
def test_no_timer_creates_no_cuda_event(files, monkeypatch, path):
    """Without a timer a window adds nothing for its measurement: no
    CUDA event, no synchronisation."""
    def refuse(*a, **k):
        raise AssertionError("a window without a timer asked the card")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    call, kw = _PATHS[path]
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device="cpu", **SMALL, **kw)
    assert tp.timer is None
    assert np.all(np.isfinite(call(tp, files).corrected_tdoa_samples))


BATCH_KEYS = {"read_s", "read_busy_s", "readers", "h2d_s", "h2d_bytes",
              "staged_chunks", "pinned_allocs"}
OVERLAP_KEYS = {"chunk_segs", "n_chunks", "gather_s", "wait_s", "h2d_bytes",
                "transfer_stream_s"}


def test_load_files_counts_the_read_and_the_copy(files):
    """The batch ingest's counters, summed over the window's files; no
    byte crosses to a card on the CPU."""
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device="cpu", **SMALL)
    tp.load_files(files)
    d = tp.ingest_diag
    assert set(d) == BATCH_KEYS
    assert d["read_s"] > 0.0 and d["h2d_s"] >= 0.0 and d["h2d_bytes"] == 0


def _odd_file(path, usable=6 * 1000, extra=5):
    """A .dat file of ``usable`` bytes of whole sample groups and
    ``extra`` bytes past them."""
    np.random.default_rng(0).integers(0, 256, usable + extra,
                                      dtype=np.uint8).tofile(path)
    return str(path), usable


def test_load_dat_adds_to_the_counters_it_is_given(tmp_path):
    path, _ = _odd_file(tmp_path / "a.dat")
    diag = {"read_s": 1.0, "h2d_bytes": 7}
    cap = load_dat(path, device="cpu", diag=diag)
    assert cap.ref1.shape == (2, 1000)
    assert diag["read_s"] > 1.0 and diag["h2d_bytes"] == 7
    assert 0.0 <= diag["h2d_s"] < 10.0


@pytest.mark.cuda
def test_load_dat_counts_the_usable_bytes_to_the_card(cuda_sm90, tmp_path):
    path, usable = _odd_file(tmp_path / "a.dat")
    diag = {}
    load_dat(path, device=cuda_sm90, diag=diag)
    load_dat(path, device=cuda_sm90, diag=diag)
    assert diag["h2d_bytes"] == 2 * usable
    assert diag["read_s"] > 0.0 and diag["h2d_s"] > 0.0


# What the stage "checks" adds to a whole window's counters, and what
# the window's end adds (its solves' launches of kernel 4).
CHECK_KEYS = {"fetch_s", "d2h_bytes", "pairs", "pairs_weighted"}
SOLVE_KEYS = {"lm_launches"}
_KEYS = {"process_files": BATCH_KEYS | CHECK_KEYS | SOLVE_KEYS,
         "process_files_overlapped": OVERLAP_KEYS | CHECK_KEYS | SOLVE_KEYS}


@pytest.mark.parametrize("first,then", [
    ("process_files_overlapped", "process_files"),
    ("process_files", "process_files_overlapped"),
], ids=["overlapped-then-files", "files-then-overlapped"])
def test_ingest_diag_holds_the_last_window_only(files, first, then):
    """An overlapped window followed by a files window leaves no
    ``gather_s`` behind, and the other way no ``read_s``; each window
    holds the stage "checks"' counters and ``lm_launches`` besides."""
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device="cpu", **SMALL)
    getattr(tp, first)(files)
    assert set(tp.ingest_diag) == _KEYS[first]
    getattr(tp, then)(files)
    assert set(tp.ingest_diag) == _KEYS[then]


def test_overlapped_counters_on_the_cpu(files):
    """The stager's wait and bytes: nothing to wait for, nothing copied."""
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device="cpu", **SMALL)
    tp.process_files_overlapped(files)
    d = tp.ingest_diag
    assert d["wait_s"] == 0.0 and d["h2d_bytes"] == 0
    assert d["gather_s"] > 0.0 and d["transfer_stream_s"] is None
    assert d["n_chunks"] >= 1


def test_tail_session_reports_its_stager(files):
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device="cpu", accumulator="xla",
                                **SMALL)
    res, sess = _tail_window(tp, files)
    assert set(sess.link_diag) == OVERLAP_KEYS - {"n_chunks"}
    assert sess.link_diag["wait_s"] == 0.0
    assert np.all(np.isfinite(res.corrected_tdoa_samples))


_STAGE_LINE = re.compile(r"^  (.+?)\s+[\d.]+ ms  \(\s*[\d.]+%\)$")


def _stages(report_text):
    """The stage names of a ``--profile`` report on stderr."""
    lines = report_text.split("stage timings:\n", 1)[1].splitlines()
    assert lines[0].startswith("total ")
    return [m.group(1) for m in map(_STAGE_LINE.match, lines[1:]) if m]


# The processor CLI's flag for each path.
_RUNS = {"process_files": [], "process_files_overlapped": ["--overlap-ingest"]}


def _cli_args(files, run, *extra):
    return [str(FREQS[0]), str(FREQS[1]), CSV, *files, "--max-lag", "512",
            "--seg-len", str(1 << 14), "--json", *_RUNS[run], *extra]


@pytest.mark.parametrize("run", list(_RUNS))
def test_cli_profile_reports_the_references_stages(files, capsys, tmp_path,
                                                   run):
    """``--profile`` prints the stage report to stderr, the reference's
    stages in its order among the port's; with ``--trace DIR`` beside it
    the port writes a Chrome trace of the run into DIR."""
    args = _cli_args(files, run, "--profile")
    assert jax_cli.main(args) == 0
    want = _stages(capsys.readouterr().err)
    trace_dir = tmp_path / "trace"
    assert port_cli.main([*args, "--device", "cpu",
                          "--trace", str(trace_dir)]) == 0
    got = _stages(capsys.readouterr().err)
    assert len(want) >= 3 and _in_order(want, got)
    assert got == _expected(run, True)
    (trace,) = trace_dir.glob("trace-*.json")
    assert json.loads(trace.read_text())["traceEvents"]


def _ranges(trace_dir):
    """The names of the profiler ranges in the one trace under
    ``trace_dir``."""
    (trace,) = trace_dir.glob("trace-*.json")
    return [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("run", list(_RUNS))
def test_cli_trace_alone_labels_the_stages(files, capsys, tmp_path, run):
    """``--trace DIR`` without ``--profile`` attaches a stage timer: the
    trace holds a range per stage, under ASCII names, and nothing is
    reported."""
    trace_dir = tmp_path / "trace"
    assert port_cli.main([*_cli_args(files, run), "--device", "cpu",
                          "--trace", str(trace_dir)]) == 0
    assert "stage timings" not in capsys.readouterr().err
    got = _ranges(trace_dir)
    want = [tprof.range_label(n) for n in _expected(run, True)]
    assert "re-solve (echo-bias sigma)" in want
    assert set(want) <= set(got) and _in_order(want, got)


@pytest.mark.parametrize("run,lines", [
    ("process_files", ["file read", "reads summed", "copy wait",
                       "bytes to the card", "readers", "ring chunks",
                       "pinned allocs"]),
    ("process_files_overlapped", ["gather", "pinned wait",
                                  "bytes to the card", "chunks"]),
])
def test_cli_profile_reports_the_ingest_counters(files, capsys, run, lines):
    assert port_cli.main([*_cli_args(files, run, "--profile"),
                          "--device", "cpu"]) == 0
    report = capsys.readouterr().err.split("ingest counters:\n", 1)[1]
    labels = [ln[2:22].rstrip() for ln in report.splitlines()[:len(lines)]]
    assert labels == lines
    assert "  bytes to the card    0 B\n" in report


def test_stage_timer_opens_a_profiler_range_per_stage(tmp_path):
    t = tprof.StageTimer()
    with tprof.trace(str(tmp_path)):
        for name in ("solve", "re-solve (echo-bias σ)", "solve"):
            with t.stage(name):
                torch.ones(8).sum()
    assert _ranges(tmp_path) == ["solve", "re-solve (echo-bias sigma)",
                                 "solve"]
    assert t.order == ["solve", "re-solve (echo-bias σ)"]


@pytest.mark.parametrize("name,label", [
    ("load+decode", "load+decode"),
    ("re-solve (echo-bias σ)", "re-solve (echo-bias sigma)"),
    ("a→b", "a?b"),
])
def test_range_label_is_ascii(name, label):
    assert tprof.range_label(name) == label


@pytest.mark.parametrize("diag,want", [
    ({"read_s": 0.2, "read_busy_s": 0.7, "readers": 4, "h2d_s": 0.05,
      "h2d_bytes": 360_000_000, "staged_chunks": 24, "pinned_allocs": 0},
     ["  file read               200.0 ms",
      "  reads summed            700.0 ms",
      "  copy wait                50.0 ms",
      "  bytes to the card    360000000 B  (1.44 GB/s)",
      "  readers              4",
      "  ring chunks          24",
      "  pinned allocs        0"]),
    ({"chunk_segs": 96, "n_chunks": 5, "gather_s": 0.09, "wait_s": 0.001,
      "h2d_bytes": 0, "transfer_stream_s": None},
     ["  gather                   90.0 ms",
      "  pinned wait               1.0 ms",
      "  bytes to the card    0 B",
      "  chunks               5 of 96 segments"]),
    ({}, []),
], ids=["batch", "overlapped-cpu", "none"])
def test_ingest_report(diag, want):
    assert tprof.ingest_report(diag).splitlines() == want
