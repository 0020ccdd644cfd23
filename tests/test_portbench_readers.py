"""The benchmark's readers of the port's stages and ingest counters
(``portbench/metrics/``): ``analyze_ms``, ``read_ms``, ``h2d_ms``,
``pinned_wait_ms`` and ``unspanned_ms``, on synthetic runs (their values,
and nothing where the program counted nothing, as at a commit that lacks
the stages and counters) and on the harness's traced loop on the CPU at
400,000-sample blocks (the kernels' plain versions)."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, spec

BENCH = spec.benchmark()
NEW = ("analyze_ms", "read_ms", "h2d_ms", "pinned_wait_ms", "unspanned_ms")
TINY_BLOCK = 400_000  # 8 kernel segments, the fused route's least


def _run(windows, latencies=None):
    if latencies is None:
        latencies = [1.0] * len(windows)
    return harness.Run(setup_s=1.0, latencies=latencies,
                       window_s=sum(latencies), windows=windows)


def _window(stages=None, ingest=None):
    return {"stages": dict(stages or {}), "ingest": dict(ingest or {})}


FILES = [
    _window({"load+decode": 0.25, "prepare": 0.001, "correlate+clock": 0.04,
             "checks": 0.002, "solve": 0.03, "multipath": 0.001,
             "re-solve (echo-bias σ)": 0.03, "analyze": 0.004,
             "assemble": 0.001},
            {"read_s": 0.1, "h2d_s": 0.12, "h2d_bytes": 360_000_000}),
    _window({"load+decode": 0.27, "prepare": 0.001, "correlate+clock": 0.04,
             "checks": 0.004, "solve": 0.03, "analyze": 0.006,
             "assemble": 0.002},
            {"read_s": 0.12, "h2d_s": 0.13, "h2d_bytes": 360_000_000}),
]
OVERLAPPED = [
    _window({"mmap": 0.001, "ingest+correlate+clock": 0.1, "solve": 0.03},
            {"gather_s": 0.09, "wait_s": 0.002, "h2d_bytes": 360_000_000,
             "transfer_stream_s": 0.008, "chunk_segs": 96, "n_chunks": 5}),
    _window({"mmap": 0.001, "ingest+correlate+clock": 0.1, "solve": 0.03},
            {"gather_s": 0.08, "wait_s": 0.004, "h2d_bytes": 360_000_000,
             "transfer_stream_s": 0.008, "chunk_segs": 96, "n_chunks": 5}),
]
# What a commit without the new stages and counters leaves the readers.
PARENT_FILES = [_window({"load+decode": 0.25, "correlate+clock": 0.04,
                         "solve": 0.03})] * 2


@pytest.mark.parametrize("metric,windows,want", [
    ("analyze_ms", FILES, 1e3 * (0.008 + 0.012) / 2),
    ("read_ms", FILES, 1e3 * 0.22 / 2),
    ("h2d_ms", FILES, 1e3 * 0.25 / 2),
    ("pinned_wait_ms", OVERLAPPED, 1e3 * 0.006 / 2),
])
def test_reader_values(metric, windows, want):
    assert spec.reader(metric)(_run(windows)) == pytest.approx(want)


@pytest.mark.parametrize("metric,windows", [
    ("analyze_ms", PARENT_FILES),
    ("analyze_ms", []),
    ("read_ms", OVERLAPPED),
    ("read_ms", PARENT_FILES),
    ("h2d_ms", OVERLAPPED),
    ("h2d_ms", PARENT_FILES),
    ("pinned_wait_ms", FILES),
    ("unspanned_ms", []),
])
def test_reader_finds_nothing(metric, windows):
    assert spec.reader(metric)(_run(windows)) is None


def test_unspanned_ms_is_the_window_less_its_stages():
    run = _run(FILES, latencies=[0.4, 0.37])
    stages = [sum(w["stages"].values()) for w in FILES]
    want = 1e3 * ((0.4 - stages[0]) + (0.37 - stages[1])) / 2
    assert spec.reader("unspanned_ms")(run) == pytest.approx(want)


def test_unspanned_ms_is_not_clamped():
    """A stage inside another counts twice: the reading goes below zero
    and shows it."""
    nested = [_window({"solve": 0.03, "analyze": 0.02, "inner": 0.02})]
    got = spec.reader("unspanned_ms")(_run(nested, latencies=[0.06]))
    assert got == pytest.approx(-10.0)


def test_unspanned_ms_pairs_only_the_traced_windows():
    """The latencies run on past the traced windows; only the traced
    ones count."""
    run = _run(FILES[:1], latencies=[0.4, 9.0, 9.0])
    want = 1e3 * (0.4 - sum(FILES[0]["stages"].values()))
    assert spec.reader("unspanned_ms")(run) == pytest.approx(want)


@pytest.mark.parametrize("metric", NEW)
def test_new_metric_is_declared_with_its_cells(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert entry["moves"] == "fix_s"
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in entry.get("workloads", cells):
        assert cell in cells


@pytest.mark.parametrize("traffic,found,absent", [
    ("files", {"analyze_ms", "read_ms", "h2d_ms", "unspanned_ms"},
     {"pinned_wait_ms"}),
    ("overlapped", {"analyze_ms", "pinned_wait_ms", "unspanned_ms"},
     {"read_ms", "h2d_ms"}),
    ("fm", {"analyze_ms", "read_ms", "h2d_ms", "unspanned_ms"},
     {"pinned_wait_ms"}),
])
def test_traced_tiny_run_feeds_the_new_readers(tmp_path, traffic, found,
                                               absent):
    """The harness's traced loop on the CPU: each new reader finds its
    stages or counters where the path has them, and nothing elsewhere.
    The stages are disjoint inside the window, so what no stage covers
    is not below zero."""
    cfg = spec.config(BENCH, "omaha3-30s")
    cfg["block_samples"] = TINY_BLOCK
    trf = spec.traffic(traffic)
    dev = torch.device("cpu")
    scenes = harness.make_scenes(cfg, trf, 2 ** 33 + 17, str(tmp_path), dev)
    proc = harness.build_processor(cfg, trf, dev, str(tmp_path))
    run, answers = harness.measure(proc, trf, scenes, 0.0, dev, True,
                                   str(tmp_path), 0.0)
    assert answers and all(a is not None for _, a in answers)
    got = {m: spec.reader(m)(run) for m in NEW}
    assert {m for m, v in got.items() if v is not None} == found
    assert {m for m, v in got.items() if v is None} == absent
    assert got["analyze_ms"] > 0.0 and got["unspanned_ms"] >= 0.0
    if traffic != "overlapped":
        assert got["read_ms"] > 0.0
        assert got["read_ms"] + got["h2d_ms"] <= (
            spec.reader("load_ms")(run) + 1e-9)
    else:
        assert got["pinned_wait_ms"] == 0.0  # no copy to wait for here
