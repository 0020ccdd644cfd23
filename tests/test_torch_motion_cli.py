"""The command lines' velocity, LO-compensation and multi-emitter
options: ``tdoa_tpu_torch.cli.processor`` and
``tdoa_tpu_torch.cli.stream_processor`` against ``tdoa_tpu``'s on the
same simulated ``.dat`` files (the port on the CPU: ``--device cpu``).

On these files the port decodes to bf16 and runs its fused path
(kernels 1 and 2's plain versions) while ``tdoa_tpu`` off the TPU runs
its f32 segmented path, so their numbers are held to each other in
``test_torch_motion.py`` and ``test_torch_emitters.py`` on matched
paths. Here the port's command lines are held to the port's
``process_files`` (the same numbers) and to the reference's command
lines (the same flags, fields, report lines and emitter sets).
"""

import contextlib
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest


try:  # the card's machine has no JAX: there only the `cuda` tests run
    from tdoa_tpu.cli import processor as jax_cli
    from tdoa_tpu.cli import stream_processor as jax_stream
    from tdoa_tpu.sim import write_scene_captures
    from tdoa_tpu.sim.scene import SimScene
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.cli import processor as port_cli
from tdoa_tpu_torch.cli import stream_processor as port_stream

REPO = Path(__file__).resolve().parents[1]
CSV = str(REPO / "lat-lon-table.csv")
FREQS = ("162400000.0", "101900000.0")
NAMES = ("kx0u", "n3pay", "kf0mtl")
LLA = np.array([
    [41.18660274289527, -95.96064116595667, 355.69],
    [41.24669616513154, -96.08366304481238, 329.0],
    [41.32916620016985, -96.03513381562004, 373.18],
])
REF_TX = np.array([41.25703803095629, -95.95512763589404, 349.07])
TGT = np.array([41.30888549464701, -96.02619229605524, 356.0])
EPOCHS = (1700000000, 1700000030)
_NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?")


def _scene(**kw):
    return SimScene(station_names=NAMES, station_lla=LLA, ref_tx_lla=REF_TX,
                    tgt_tx_lla=TGT, block_len=1 << 18,
                    clock_offsets_s=np.array([5e-6, -9e-6, 14e-6]),
                    tgt_velocity_enu=np.array([120.0, -60.0, 0.0]), **kw)


# name: (scene, processor CLI flags, the processor settings they mean)
CASES = {
    "lo_velocity": (
        lambda: _scene(clock_drifts_ppm=np.array([0.08, -0.05, 0.02]),
                       drift_doppler=True, seed=7),
        ["--lo-compensation", "--solve-velocity"],
        dict(lo_compensation="auto", solve_velocity=True)),
    "joint": (
        lambda: _scene(interferer_lla=np.array([41.05, -95.99, 340.0]),
                       interferer_amplitude=1.0, seed=5),
        ["--solve-velocity", "--multi-emitter", "2"],
        dict(solve_velocity=True, multi_emitter=2)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def capture_dir(request, tmp_path_factory):
    """Two epoch windows of one scene in a directory."""
    make, flags, cfg = CASES[request.param]
    d = tmp_path_factory.mktemp(f"caps-{request.param}")
    sc = make()
    for ep in EPOCHS:
        write_scene_captures(sc, str(d), prefix="", epoch=ep)
    files = sorted(str(p) for p in d.glob(f"*-{EPOCHS[0]}.dat"))
    return d, files, flags, cfg


@pytest.fixture(scope="module")
def cli_json(capture_dir):
    """Both processor CLIs' ``--json`` records on the first window, and
    the port's ``process_files`` on the same files and settings."""
    from tdoa_tpu_torch.pipeline import TDOAProcessor

    _, files, flags, cfg = capture_dir
    out = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", port_cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([*FREQS, CSV, *files, "--max-lag", "512", *flags,
                         "--json", *extra]) == 0
        out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    out["api"] = TDOAProcessor.from_csv(
        *map(float, FREQS), CSV, device="cpu", max_lag=512,
        **cfg).process_files(files)
    return out


def test_cli_json_is_process_files(cli_json):
    """The new fields are the processor's result, unrounded."""
    t, r = cli_json["port"], cli_json["api"]
    np.testing.assert_array_equal(t["tdoa_us"], r.tdoa_seconds * 1e6)
    np.testing.assert_array_equal(t["fdoa_hz"], r.fdoa_hz)
    np.testing.assert_array_equal(t["velocity_enu_mps"], r.velocity_enu)
    np.testing.assert_array_equal(t["velocity_sigma_mps"],
                                  r.velocity_sigma_enu)
    assert t["velocity_residual_hz"] == r.velocity_residual_hz
    assert (t["emitters"] is None) == (r.emitters is None)
    for et, e in zip(t["emitters"] or [], r.emitters or []):
        assert (et["lat"], et["lon"]) == (e.fix.lat, e.fix.lon)
        np.testing.assert_array_equal(et["tdoa_samples"], e.tdoa_samples)
        np.testing.assert_array_equal(et["fdoa_hz"], e.fdoa_hz)
        np.testing.assert_array_equal(et["velocity_enu_mps"], e.velocity_enu)
        np.testing.assert_array_equal(et["velocity_sigma_mps"],
                                      e.velocity_sigma_enu)


def test_cli_json_has_the_reference_fields(cli_json):
    """The reference's keys, top level and per emitter, and the same
    number of emitters."""
    j, t = cli_json["jax"], cli_json["port"]
    assert set(t) == set(j)
    assert (t["emitters"] is None) == (j["emitters"] is None)
    assert len(t["emitters"] or []) == len(j["emitters"] or [])
    for et, ej in zip(t["emitters"] or [], j["emitters"] or []):
        assert set(et) == set(ej)


def test_cli_text_reports_velocity_and_emitters(capture_dir, capsys):
    """The text report's velocity line and emitter list: the reference's
    lines, word for word."""
    _, files, flags, _ = capture_dir
    lines = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", port_cli.main, ["--device", "cpu"])):
        assert main([*FREQS, CSV, *files, "--max-lag", "512", *flags,
                     *extra]) == 0
        out = capsys.readouterr().out.splitlines()
        lines[name] = [_NUMBER.sub("#", ln) for ln in out
                       if ln.startswith(("Emitter velocity", "  emitter ",
                                         "Separated co-channel"))]
    assert any(ln.startswith("Emitter velocity") for ln in lines["port"])
    assert lines["port"] == lines["jax"]


def test_cli_passes_the_fdoa_and_speed_settings(monkeypatch, capture_dir):
    """``--no-fdoa-disambiguation`` and ``--max-emitter-speed`` reach the
    processor's configuration."""
    from tdoa_tpu_torch.pipeline import TDOAProcessor

    _, files, _, _ = capture_dir
    seen = {}

    def fake(*a, **kw):
        seen.update(kw)
        raise RuntimeError("stop here")

    monkeypatch.setattr(TDOAProcessor, "from_csv", fake)
    assert port_cli.main([*FREQS, CSV, *files, "--no-fdoa-disambiguation",
                          "--max-emitter-speed", "300", "--lo-compensation",
                          "--device", "cpu"]) == 2
    assert seen["fdoa_disambiguation"] is False
    assert seen["max_emitter_speed_mps"] == 300.0
    assert seen["lo_compensation"] == "auto"
    assert (seen["solve_velocity"], seen["multi_emitter"]) == (False, 1)


def test_stream_cli_tracks_velocity_and_emitters(capture_dir, cli_json,
                                                 tmp_path):
    """Two windows through both stream services with the case's
    velocity / multi-emitter flags: the reference's track ids; the
    first window's track velocity is the processor's own (the
    measurement reaches the tracker at once, joint emitters each with
    their own)."""
    d, _, flags, _ = capture_dir
    flags = [f for f in flags if f != "--lo-compensation"]
    recs = {}
    for name, main, extra in (("jax", jax_stream.main, []),
                              ("port", port_stream.main,
                               ["--device", "cpu"])):
        jsonl = tmp_path / f"{name}.jsonl"
        assert main([*FREQS, CSV, str(d), "--max-lag", "512",
                     "--seg-len", str(1 << 16), *flags,
                     "--jsonl", str(jsonl), *extra]) == 0
        recs[name] = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert [(r["epoch"], r["id"]) for r in recs["port"]] == \
        [(r["epoch"], r["id"]) for r in recs["jax"]]
    first = [r for r in recs["port"] if r["epoch"] == EPOCHS[0]]
    speeds = sorted(np.hypot(r["track"]["vel_e_mps"], r["track"]["vel_n_mps"])
                    for r in first)
    assert speeds[-1] > 50.0


@pytest.mark.parametrize("flag", [["--solve-velocity"],
                                  ["--multi-emitter", "2"]])
def test_stream_cli_refuses_overlap_ingest_with_whole_block_options(
        flag, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        port_stream.main(["1", "2", CSV, str(tmp_path), "--overlap-ingest",
                          "30", *flag])
    assert e.value.code == 2
    assert "needs whole blocks on device" in capsys.readouterr().err
