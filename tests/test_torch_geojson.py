"""GeoJSON export of the port (``tdoa_tpu_torch/io/geojson.py``, a copy
of the reference's) and the ``--geojson`` option of both CLIs.

- The five cases of ``tests/test_geojson.py`` on the port's own results
  (its ``solve_fix``, ``TDOAResult``, ``TargetTracker``); on the same
  result object the reference module writes the same collection.
- Both CLIs on the same simulated files as the reference's CLIs: the
  same features in the same order; station and reference-transmitter
  points equal; fix, track, trail and ellipse points within 1e-5
  degrees (~1 m) and 1 m of elevation; other numbers (ellipse sizes,
  speeds) within 5 % (the σ tolerance of the pipeline tests) or 0.05.
  Both run the segmented correlator (a lag window beyond kernel 1's).
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

from _torch_port_helpers import OMAHA_NAMES

try:  # the card's machine has no JAX
    from tdoa_tpu.cli import processor as jax_cli
    from tdoa_tpu.cli import stream_processor as jax_stream
    from tdoa_tpu.io import geojson as jgeo
    from tdoa_tpu.sim import SimScene, write_scene_captures
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.cli import processor as port_cli
from tdoa_tpu_torch.cli import stream_processor as port_stream
from tdoa_tpu_torch.geo import lla_to_ecef, lla_to_enu
from tdoa_tpu_torch.io.geojson import (
    ellipse_ring,
    result_feature_collection,
    tracks_feature_collection,
)
from tdoa_tpu_torch.pipeline.processor import TDOAResult
from tdoa_tpu_torch.pipeline.streaming import TargetTracker
from tdoa_tpu_torch.solve import solve_fix, station_pairs
from tdoa_tpu_torch.utils.constants import SPEED_OF_LIGHT

REPO = Path(__file__).resolve().parents[1]
CSV = str(REPO / "lat-lon-table.csv")
LLA3 = np.array(
    [
        [41.18660274289527, -95.96064116595667, 355.69],
        [41.24669616513154, -96.08366304481238, 329.0],
        [41.32916620016985, -96.03513381562004, 373.18],
    ]
)
NAMES = OMAHA_NAMES
TX = np.array([41.30888549464701, -96.02619229605524, 356.0])
REF_TX = np.array([41.25703803095629, -95.95512763589404, 349.07])
FREQS = ("162400000", "101900000")


def _tdoa():
    st = lla_to_ecef(LLA3)
    pairs = station_pairs(3)
    d = np.linalg.norm(st - lla_to_ecef(TX), axis=-1)
    return pairs, (d[pairs[:, 1]] - d[pairs[:, 0]]) / SPEED_OF_LIGHT


def _result():
    pairs, tdoa = _tdoa()
    fix = solve_fix(LLA3, tdoa, tdoa_sigma_s=[2e-8] * 3)
    m = len(pairs)
    return TDOAResult(
        fix=fix,
        station_names=list(NAMES),
        pair_idx=pairs,
        tgt_delay_samples=np.zeros(m),
        ref_delay_samples=np.zeros((m, 2)),
        clock_offset_samples=np.zeros(m),
        corrected_tdoa_samples=tdoa * 2e6,
        tdoa_seconds=tdoa,
        quality=np.full(m, 50.0),
        peak_value=np.ones(m),
        tdoa_std_s=np.full(m, 2e-8),
        warnings=["example warning"],
        velocity_enu=np.array([30.0, 40.0, 0.0]),
    )


def test_ellipse_ring_geometry():
    center = np.array([41.3, -96.0, 350.0])
    ring = ellipse_ring(center, 200.0, 80.0, 30.0, k_sigma=2.0)
    assert ring[0] == ring[-1]  # closed
    for lon, lat in ring[:-1]:
        en = lla_to_enu(np.array([lat, lon, center[2]]), center)[:2]
        r = np.linalg.norm(en)
        assert 2.0 * 80.0 - 1.0 <= r <= 2.0 * 200.0 + 1.0
    lon0, lat0 = ring[0]
    e, n = lla_to_enu(np.array([lat0, lon0, center[2]]), center)[:2]
    az = np.degrees(np.arctan2(e, n)) % 360.0
    assert abs(az - 30.0) < 1.0
    assert abs(np.hypot(e, n) - 400.0) < 1.0
    assert ring == jgeo.ellipse_ring(center, 200.0, 80.0, 30.0, k_sigma=2.0)


def test_ellipse_ring_winding_and_antimeridian():
    ring = ellipse_ring(np.array([41.3, -96.0, 350.0]), 200.0, 80.0, 30.0)
    xy = np.asarray(ring)
    area2 = float(np.sum(xy[:-1, 0] * xy[1:, 1] - xy[1:, 0] * xy[:-1, 1]))
    assert area2 > 0.0
    assert ring[0] == ring[-1]
    ring_am = ellipse_ring(np.array([0.0, 179.9999, 0.0]), 5000.0, 3000.0,
                           10.0)
    lons = np.asarray([p[0] for p in ring_am])
    assert np.abs(np.diff(lons)).max() < 1.0, "360-degree jump mid-ring"
    assert ring_am == jgeo.ellipse_ring(np.array([0.0, 179.9999, 0.0]),
                                        5000.0, 3000.0, 10.0)


def test_result_feature_collection():
    res = _result()
    fc = result_feature_collection(res, LLA3, NAMES, ref_tx_lla=REF_TX)
    assert fc["type"] == "FeatureCollection"
    kinds = [f["properties"]["kind"] for f in fc["features"]]
    assert kinds.count("station") == 3
    assert "reference_tx" in kinds
    assert kinds.count("error_ellipse") == 2
    assert "course" in kinds
    fix = next(f for f in fc["features"] if f["properties"]["kind"] == "fix")
    lon, lat, _ = fix["geometry"]["coordinates"]
    assert abs(lat - TX[0]) < 0.01 and abs(lon - TX[1]) < 0.01
    assert fix["properties"]["warnings"] == ["example warning"]
    assert abs(fix["properties"]["speed_mps"] - 50.0) < 0.1
    assert abs(fix["properties"]["heading_deg"] - 36.87) < 0.5
    course = next(f for f in fc["features"]
                  if f["properties"]["kind"] == "course")
    a, b = course["geometry"]["coordinates"]
    lead = lla_to_enu(np.array([b[1], b[0], TX[2]]),
                      np.array([a[1], a[0], TX[2]]))[:2]
    assert abs(np.linalg.norm(lead) - 3000.0) < 10.0
    assert json.loads(json.dumps(fc)) == fc
    # the reference module writes the same collection from this result
    assert jgeo.result_feature_collection(res, LLA3, NAMES,
                                          ref_tx_lla=REF_TX) == fc


def test_tracks_feature_collection():
    _, tdoa = _tdoa()
    tracker = TargetTracker(LLA3)
    for k in range(3):
        tracker.update(float(k), {"t": tdoa})
    hist = {"t": [[41.30, -96.03], [41.31, -96.02]]}
    fc = tracks_feature_collection(tracker, LLA3, NAMES, history=hist)
    kinds = [f["properties"]["kind"] for f in fc["features"]]
    assert kinds.count("station") == 3
    assert "track" in kinds and "trail" in kinds
    tr = next(f for f in fc["features"] if f["properties"]["kind"] == "track")
    assert tr["properties"]["n_updates"] == 3
    lon, lat, _ = tr["geometry"]["coordinates"]
    assert abs(lat - TX[0]) < 0.01 and abs(lon - TX[1]) < 0.01
    trail = next(f for f in fc["features"]
                 if f["properties"]["kind"] == "trail")
    assert trail["geometry"]["coordinates"][0] == [-96.03, 41.30]
    assert "ellipse_1sigma_m" not in tr["properties"]
    assert "track_error_ellipse" not in kinds
    assert jgeo.tracks_feature_collection(tracker, LLA3, NAMES,
                                          history=hist) == fc


def test_tracks_feature_collection_kalman_ellipse():
    _, tdoa = _tdoa()
    tracker = TargetTracker(LLA3)
    p0 = lla_to_enu(TX, tracker.origin)
    for k in range(3):
        tracker.update(float(k), {"t": tdoa}, positions_enu={"t": p0},
                       covs_en={"t": np.diag([400.0, 100.0])})
    fc = tracks_feature_collection(tracker, LLA3, NAMES)
    tr = next(f for f in fc["features"] if f["properties"]["kind"] == "track")
    ell = tr["properties"]["ellipse_1sigma_m"]
    assert ell["semi_major"] >= ell["semi_minor"] > 0.0
    ring = next(f for f in fc["features"]
                if f["properties"]["kind"] == "track_error_ellipse")
    coords = np.asarray(ring["geometry"]["coordinates"][0])
    assert coords.shape[1] == 2 and len(coords) >= 16
    lon, lat, _ = tr["geometry"]["coordinates"]
    assert abs(coords[:, 0].mean() - lon) < 1e-3
    assert abs(coords[:, 1].mean() - lat) < 1e-3
    assert jgeo.tracks_feature_collection(tracker, LLA3, NAMES) == fc


# ---- the CLIs against the reference's on the same files --------------

def _points_close(a, b, path=""):
    """Same JSON structure; numbers within 1e-5 degrees of coordinates
    and 5 % of other properties; strings and counts equal."""
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _points_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for k, (u, v) in enumerate(zip(a, b)):
            _points_close(u, v, f"{path}[{k}]")
    elif isinstance(a, float):
        if path.endswith("coordinates[2]"):  # a point's elevation, m
            assert abs(a - b) < 1.0, (path, a, b)
        elif "coordinates" in path:
            assert abs(a - b) < 1e-5, (path, a, b)
        elif not ("warnings" in path or "rms_residual" in path
                  or "azimuth" in path or "heading" in path):
            assert math.isclose(a, b, rel_tol=0.05, abs_tol=0.05), \
                (path, a, b)
    elif "warnings" not in path:
        assert a == b, (path, a, b)


# A lag window beyond kernel 1's alias-free 20480 samples: on the CPU
# both packages then correlate on the segmented path, so their σs (and
# ellipses) are the same estimator's.
SEGMENTED = ["--max-lag", "20481"]


@pytest.fixture(scope="module")
def epoch_dir(tmp_path_factory):
    """Two epochs of a 3 × 2¹⁷-sample scene with clock offsets, written
    by the JAX simulator, one directory."""
    root = tmp_path_factory.mktemp("geojson-epochs")
    for k, ep in enumerate((1700000000, 1700000030)):
        sc = SimScene(
            station_names=NAMES, station_lla=LLA3, ref_tx_lla=REF_TX,
            tgt_tx_lla=TX, block_len=1 << 17, seed=21 + k,
            clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]))
        write_scene_captures(sc, str(root), prefix="", epoch=ep)
    return root


def test_processor_cli_geojson_matches_the_reference(epoch_dir, tmp_path,
                                                     capsys):
    files = sorted(str(p) for p in epoch_dir.glob("*-1700000000.dat"))
    common = [*FREQS, CSV, *files, *SEGMENTED]
    want, got = tmp_path / "jax.geojson", tmp_path / "port.geojson"
    assert jax_cli.main([*common, "--geojson", str(want)]) == 0
    assert port_cli.main([*common, "--device", "cpu", "--json",
                          "--geojson", str(got)]) == 0
    io = capsys.readouterr()
    assert f"GeoJSON written to {got}" in io.err  # beside --json: stderr
    fc_j, fc_t = json.loads(want.read_text()), json.loads(got.read_text())
    kinds = [f["properties"]["kind"] for f in fc_t["features"]]
    assert kinds[:5] == ["station"] * 3 + ["reference_tx", "fix"]
    assert kinds.count("error_ellipse") == 2
    _points_close(fc_t, fc_j)
    fix = next(f for f in fc_t["features"] if f["properties"]["kind"] == "fix")
    assert abs(fix["geometry"]["coordinates"][1] - TX[0]) < 2e-3
    # an unwritable path warns and keeps the fix
    assert port_cli.main([*common, "--device", "cpu", "--geojson",
                          str(tmp_path / "no" / "such" / "dir.json")]) == 0
    io = capsys.readouterr()
    assert "could not write --geojson" in io.err and "Position fix" in io.out


def test_stream_cli_geojson_matches_the_reference(epoch_dir, tmp_path,
                                                  capsys):
    args = [*FREQS, CSV, str(epoch_dir), *SEGMENTED, "--seg-len",
            str(1 << 16)]
    want, got = tmp_path / "jax.geojson", tmp_path / "port.geojson"
    state = tmp_path / "state.json"
    assert jax_stream.main([*args, "--geojson", str(want)]) == 0
    assert port_stream.main([*args, "--device", "cpu", "--geojson", str(got),
                             "--state", str(state)]) == 0
    capsys.readouterr()
    fc_j, fc_t = json.loads(want.read_text()), json.loads(got.read_text())
    kinds = [f["properties"]["kind"] for f in fc_t["features"]]
    assert kinds == ["station"] * 3 + ["track", "track_error_ellipse",
                                       "trail"]
    trail = fc_t["features"][-1]
    assert len(trail["geometry"]["coordinates"]) == 2  # one point a window
    _points_close(fc_t, fc_j)
    assert not list(tmp_path.glob("*.tmp"))  # atomic rewrite left nothing
    # the trails ride along in --state, as the reference writes them
    st = json.loads(state.read_text())
    assert [[round(v, 9) for v in p] for p in st["track_history"]["target"]] \
        == [[round(lat, 9), round(lon, 9)]
            for lon, lat in trail["geometry"]["coordinates"]]
