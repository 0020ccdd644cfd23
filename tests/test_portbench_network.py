"""The 24-station configuration of the benchmark (``omaha24-30s``) and
what it reads: its window through ``process_files`` against the plain
reference at 400,000-sample blocks with the kernels' plain versions,
the ``k1_net_roofline`` bound that counts a block's work once however
many pair tiles carried it, and the stage "checks"' counters
(``fetch_s``, ``d2h_bytes``, ``pairs``, ``pairs_weighted`` in
``TDOAProcessor.ingest_diag``) with their reader ``fetch_ms`` and
``--profile``'s report of them."""

from __future__ import annotations

import collections

import pytest
import torch

from _torch_port_helpers import cuda_sm90  # noqa: F401
from portbench import harness, roofline, scene, spec
from tdoa_tpu_torch.cli import processor as port_cli

BENCH = spec.benchmark()
TINY_BLOCK = 400_000  # 8 kernel segments, the fused route's least
CPU = torch.device("cpu")
CHECK_KEYS = ("fetch_s", "d2h_bytes", "pairs", "pairs_weighted")
# The cell's own limits (set on the card at 20 M-sample blocks). A
# 400,000-sample block has 8 of their 443 segments, so its delays are
# noisier, but the program and the reference read the same bytes: at
# seed 2**33 + 29 on the CPU the program read 2.9e-4 sample and 3.7 mm
# from the reference, and the bfloat16 reference 0.92 sample and 3.5 m.
# The limits lie between, 200x and 15x from them in TDOA, 22x and 44x
# in the fix.
LIMITS = spec.limits("omaha24-30s.files")["limits"]
# The planted geometry, as the smoke holds its 30 s scenes to it.
TRUTH_SAMPLES = 0.5


def _tiny(config: str) -> dict:
    cfg = spec.config(BENCH, config)
    cfg["block_samples"] = TINY_BLOCK
    return cfg


def _one_scene(traffic: str) -> dict:
    return {**spec.traffic(traffic), "scenes": 1}


@pytest.fixture(scope="module")
def network(tmp_path_factory):
    """One 24-station window through ``process_files`` and the float64
    reference's answer to the same files."""
    tmp = str(tmp_path_factory.mktemp("net24"))
    cfg, trf = _tiny("omaha24-30s"), _one_scene("files")
    scenes = harness.make_scenes(cfg, trf, 2 ** 33 + 29, tmp, CPU)
    proc = harness.build_processor(cfg, trf, CPU, tmp)
    res = proc.process_files(scenes[0])
    ref = harness.reference_answers(cfg, trf, scenes, CPU)[0]
    return {"cfg": cfg, "res": res, "ref": ref,
            "diag": dict(proc.ingest_diag)}


def test_network_has_24_stations_and_276_pairs(network):
    res = network["res"]
    assert len(res.station_names) == 24
    assert len(res.pair_idx) == 276
    assert sorted(res.station_names) == scene.receivers(network["cfg"])


@pytest.mark.parametrize("number", sorted(LIMITS))
def test_network_window_matches_the_reference(network, number):
    got = harness.gaps(harness.program_answer(network["res"]), network["ref"],
                       network["cfg"])
    assert got[number] <= LIMITS[number], got


def test_network_window_meets_the_planted_geometry(network):
    ans = harness.program_answer(network["res"])
    assert harness.truth_error(ans, network["cfg"]) < TRUTH_SAMPLES


def test_network_window_counts_its_pairs(network):
    d = network["diag"]
    assert d["pairs"] == 276
    assert 3 <= d["pairs_weighted"] <= 276
    assert d["fetch_s"] > 0.0 and d["d2h_bytes"] == 0  # nothing leaves a card


# Kernel 1's launch shapes (rows, segments, banks, pairs) of one block
# and its pair tiles, as ``plan_tiles`` cuts them on the H100.
TILE_PLANS = {
    "24 st, 6 tiles of 46": ({(24, 443, 4, 46): 6}, (24, 443, 4, 276)),
    "16 st, 2 tiles of 60": ({(16, 443, 4, 60): 2}, (16, 443, 4, 120)),
    "14 st, 46 + 45": ({(14, 443, 4, 46): 1, (14, 443, 4, 45): 1},
                       (14, 443, 4, 91)),
    "24 st at 100 s": ({(24, 1479, 4, 46): 6}, (24, 1479, 4, 276)),
    "3 st, untiled": ({(3, 443, 4, 3): 1}, (3, 443, 4, 3)),
}


def _net_metric():
    import importlib.util

    path = spec.HERE / "metrics" / "k1_net_roofline.py"
    mod_spec = importlib.util.spec_from_file_location("k1_net_roofline",
                                                      path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("tiles,whole", TILE_PLANS.values(),
                         ids=TILE_PLANS.keys())
@pytest.mark.parametrize("blocks", [1, 3])
def test_k1_net_least_time_is_the_tile_plans_own(tiles, whole, blocks):
    """A block's tiles and one untiled launch of the same block have one
    least time: the block's, ``roofline.k1_bound`` of all its pairs."""
    net = _net_metric()
    tiled = {k: blocks * n for k, n in tiles.items()}
    rows, segs, banks, pairs = whole
    want = blocks * roofline.k1_bound(rows, pairs, segs, banks)["seconds"]
    assert net.least_seconds(tiled) == pytest.approx(want, rel=1e-12)
    assert net.least_seconds({whole: blocks}) == pytest.approx(want,
                                                               rel=1e-12)


def test_k1_roofline_counts_each_tiles_stage_1_again():
    """The accepted ``k1_roofline`` reads a 6-tile plan as more work than
    the block: what ``k1_net_roofline`` is for."""
    tiles, whole = TILE_PLANS["24 st, 6 tiles of 46"]
    per_tile = sum(n * roofline.k1_bound(r, m, s, b)["seconds"]
                   for (r, s, b, m), n in tiles.items())
    assert per_tile > 1.05 * _net_metric().least_seconds({whole: 1})


class _Trace:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_s(self, substrings):
        assert substrings == ("corr_accum_kernel",)
        return self.seconds


def _run(windows=(), launches=None, trace=None):
    return harness.Run(setup_s=1.0, latencies=[1.0] * len(windows),
                       window_s=float(len(windows)), windows=list(windows),
                       launches=launches or {}, trace=trace)


def test_k1_net_roofline_reads_the_share():
    shapes = collections.Counter({(24, 443, 4, 46): 18})
    run = _run(launches={"corr_accum": shapes}, trace=_Trace(0.1293))
    want = 100.0 * 3 * roofline.k1_bound(24, 276, 443, 4)["seconds"] / 0.1293
    assert spec.reader("k1_net_roofline")(run) == pytest.approx(want)


@pytest.mark.parametrize("run", [
    _run(),
    _run(launches={"corr_accum": collections.Counter()},
         trace=_Trace(0.1)),
    _run(launches={"corr_accum": collections.Counter({(3, 443, 4, 3): 3})},
         trace=_Trace(0.0)),
], ids=["untraced", "no-launch", "no-device-time"])
def test_k1_net_roofline_finds_nothing(run):
    assert spec.reader("k1_net_roofline")(run) is None


def _window(ingest):
    return {"stages": {"checks": 0.01}, "ingest": dict(ingest)}


@pytest.mark.parametrize("windows,want", [
    ([_window({"fetch_s": 0.2}), _window({"fetch_s": 0.3})], 250.0),
    ([_window({"fetch_s": 0.2}), _window({})], 100.0),
    ([_window({"read_s": 0.1}), _window({})], None),
    ([], None),
], ids=["two", "one-of-two", "parent", "untraced"])
def test_fetch_ms_reader(windows, want):
    got = spec.reader("fetch_ms")(_run(windows))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("metric", ["k1_net_roofline", "fetch_ms"])
def test_new_metrics_are_declared_for_the_network_cell(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert entry["workloads"] == ["omaha24-30s.files"]
    assert entry["moves"] == "fix_s"


@pytest.fixture(scope="module")
def omaha3(tmp_path_factory):
    """The 3-station tiny files, their stations' CSV and one processor."""
    tmp = str(tmp_path_factory.mktemp("omaha3"))
    cfg, trf = _tiny("omaha3-30s"), _one_scene("files")
    paths = harness.make_scenes(cfg, trf, 2 ** 33 + 31, tmp, CPU)[0]
    return {"cfg": cfg, "paths": paths,
            "proc": harness.build_processor(cfg, trf, CPU, tmp),
            "csv": harness.write_stations(cfg, f"{tmp}/stations.csv")}


@pytest.mark.parametrize("entry", ["process_files",
                                   "process_files_overlapped"])
def test_checks_counters_are_set_anew_every_window(omaha3, entry):
    """What an earlier window left is not what this one reads."""
    proc = omaha3["proc"]
    proc.ingest_diag.update({"fetch_s": -1.0, "d2h_bytes": -1, "pairs": -1,
                             "pairs_weighted": -1, "lm_launches": -1})
    getattr(proc, entry)(omaha3["paths"])
    d = proc.ingest_diag
    assert d["pairs"] == 3 and 0 < d["pairs_weighted"] <= 3
    assert d["lm_launches"] == 0  # the CPU solves take the plain loop
    assert d["fetch_s"] > 0.0 and d["d2h_bytes"] == 0


def test_load_files_clears_the_checks_counters(omaha3):
    proc = omaha3["proc"]
    proc.ingest_diag.update({k: 1 for k in CHECK_KEYS})
    proc.load_files(omaha3["paths"])
    assert not set(CHECK_KEYS) & set(proc.ingest_diag)


def test_cli_profile_reports_the_checks_counters(omaha3, capsys):
    cfg = omaha3["cfg"]
    assert port_cli.main([str(cfg["ref_freq"]), str(cfg["tgt_freq"]),
                          omaha3["csv"], *omaha3["paths"], "--json",
                          "--profile", "--device", "cpu"]) == 0
    report = capsys.readouterr().err.split("checks counters:\n", 1)[1]
    labels = [ln[2:22].rstrip() for ln in report.splitlines()[:5]]
    assert labels == ["fetch", "bytes to the host", "pairs",
                      "pairs weighted", "LM launches"]
    assert "  bytes to the host    0 B\n" in report
    assert "  pairs                3\n" in report


@pytest.mark.cuda
def test_checks_fetch_through_pinned_buffers_on_the_card(cuda_sm90,
                                                         tmp_path):
    """Two windows on the card: the lag windows reach the host through
    the same pinned buffers, every output's bytes are counted, and the
    second window's answer is the first's."""
    cfg, trf = _tiny("omaha3-30s"), _one_scene("files")
    paths = harness.make_scenes(cfg, trf, 2 ** 33 + 37, str(tmp_path),
                                cuda_sm90)[0]
    proc = harness.build_processor(cfg, trf, cuda_sm90, str(tmp_path))
    first = proc.process_files(paths)
    bufs = {k: v.data_ptr() for k, v in proc._pinned.items()}
    second = proc.process_files(paths)
    assert set(bufs) == {"tgt_window", "win_c"}
    assert all(proc._pinned[k].is_pinned() and
               proc._pinned[k].data_ptr() == ptr for k, ptr in bufs.items())
    d = proc.ingest_diag
    assert d["d2h_bytes"] >= proc._pinned["win_c"].numel() * 8
    assert d["pairs"] == 3 and d["fetch_s"] > 0.0
    # Kernel 4 once a solve: the first, and the echo-bias re-solve.
    assert d["lm_launches"] == 1 + (second.multipath_sigma_samples
                                    is not None)
    assert (first.corrected_tdoa_samples
            == second.corrected_tdoa_samples).all()
    assert first.fix.lat == second.fix.lat and first.fix.lon == second.fix.lon
