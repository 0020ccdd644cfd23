"""The IQ main path end to end: one simulated ``.dat`` scene through
``tdoa_tpu`` (``TDOAProcessor(accumulator="pallas")``, both Pallas
kernels in interpret mode) and through ``tdoa_tpu_torch``
(``process_files`` on CPU tensors, the kernels' plain versions)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90, fm_block, scene  # noqa: F401

try:  # the card's machine has no JAX: there only the `cuda` tests run
    import jax
    from tdoa_tpu.ops import corr as jcorr
    from tdoa_tpu.pipeline import TDOAProcessor as JaxProcessor
    from tdoa_tpu.sim import NoiseProfile, write_scene_captures
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.cli import processor as port_cli
from tdoa_tpu_torch.io.datfile import save_dat
from tdoa_tpu_torch.pipeline import TDOAProcessor

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
    "ref_freq": 162_400_000.0,
    "tgt_freq": 101_900_000.0,
}
# Emitters: the reference deployment's KEVO target inside the network,
# and a site outside it (a candidate for a second, ghost intersection).
EMITTERS = {
    "kevo": np.array([41.30888549464701, -96.02619229605524, 356.0]),
    "outside": np.array([41.05, -96.30, 350.0]),
}
BLOCK = 8 * 45056  # 8 kernel segments per block → K = 4 split banks
_NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?")


@pytest.fixture(scope="module", params=sorted(EMITTERS))
def slice_run(request, tmp_path_factory):
    """(jax result, port result, truth, paths) for one scene. Noise puts
    the σs at ~0.5-3 samples, where both sides' σ is set by the signal,
    not by the TPU kernel's bf16 DFT-operand rounding."""
    prof = NoiseProfile(signal_amplitude=0.3, noise_amplitude=0.15)
    sc = scene({**OMAHA, "tgt_tx_lla": EMITTERS[request.param]}, BLOCK,
               seed=5, ref_profile=prof, tgt_profile=prof,
               clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]))
    out = tmp_path_factory.mktemp(f"scene-{request.param}")
    paths, truth = write_scene_captures(sc, str(out))
    files = sorted(paths.values())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcorr, "_FORCE_PROBE_KERNEL", True)
        jax.clear_caches()  # the probe routing is decided at trace time
        try:
            rj = JaxProcessor.from_csv(
                OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV, max_lag=512,
                accumulator="pallas").process_files(files)
        finally:
            jax.clear_caches()
    rt = TDOAProcessor.from_csv(OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV,
                                device="cpu", max_lag=512).process_files(files)
    return rj, rt, truth, files


def test_same_station_order_and_pairs(slice_run):
    rj, rt, _, _ = slice_run
    assert rt.station_names == rj.station_names
    np.testing.assert_array_equal(rt.pair_idx, rj.pair_idx)


def test_corrected_tdoas_match(slice_run):
    """Clock-corrected TDOAs within 5e-3 samples (bf16 operands)."""
    rj, rt, _, _ = slice_run
    np.testing.assert_allclose(rt.corrected_tdoa_samples,
                               rj.corrected_tdoa_samples, atol=5e-3)
    np.testing.assert_allclose(rt.tgt_delay_samples, rj.tgt_delay_samples,
                               atol=5e-3)
    np.testing.assert_allclose(rt.ref_delay_samples, rj.ref_delay_samples,
                               atol=5e-3)


def test_sigmas_match(slice_run):
    """Composite 1σ (model σ, split-σ probe, REF clock variance,
    multipath accounting) within 5 % relative."""
    rj, rt, _, _ = slice_run
    np.testing.assert_allclose(rt.tdoa_std_s, rj.tdoa_std_s, rtol=0.05)


def _words_and_numbers(text):
    nums = [float(v) for v in _NUMBER.findall(text)]
    return _NUMBER.sub("#", text), nums


def test_warnings_and_ghost_verdict_match(slice_run):
    """Same warnings, word for word; the numbers they quote (ghost
    candidate position, margins) agree to the last printed digit or
    1e-3 relative — float32 LM rounding moves a 24 km-away ghost
    candidate by ~1 m."""
    rj, rt, _, _ = slice_run
    assert len(rt.warnings) == len(rj.warnings)
    for wt, wj in zip(rt.warnings, rj.warnings):
        tt, nt = _words_and_numbers(wt)
        tj, nj = _words_and_numbers(wj)
        assert tt == tj
        np.testing.assert_allclose(nt, nj, rtol=1e-3, atol=0.1)
    assert (rt.ghost is None) == (rj.ghost is None)
    if rj.ghost is not None:
        assert rt.ghost.best == rj.ghost.best
        assert rt.ghost.decided == rj.ghost.decided
    assert rt.excluded_stations == rj.excluded_stations


def test_fix_matches_within_its_ellipse(slice_run):
    """The fixes differ by less than 5 % of the fix's own 1σ ellipse
    (semi-minor axis)."""
    rj, rt, _, _ = slice_run
    from tdoa_tpu_torch.geo import lla_to_enu

    d = lla_to_enu(np.array([rt.fix.lat, rt.fix.lon, rj.fix.elev]),
                   np.array([rj.fix.lat, rj.fix.lon, rj.fix.elev]))
    assert np.linalg.norm(d[:2]) < 0.05 * rj.fix.ellipse[1]
    np.testing.assert_allclose(rt.fix.ellipse[:2], rj.fix.ellipse[:2],
                               rtol=0.05)


def test_port_recovers_the_planted_tdoas(slice_run):
    """Against the simulator's truth: corrected TDOAs within 3σ."""
    _, rt, truth, _ = slice_run
    tau = dict(zip(OMAHA["names"], truth.station_delays_samples[:, 1]))
    want = np.array([tau[rt.station_names[j]] - tau[rt.station_names[i]]
                     for i, j in rt.pair_idx])
    sig = rt.tdoa_std_s * 2e6
    assert np.all(np.abs(rt.corrected_tdoa_samples - want) < 3 * sig + 0.05)


def test_cli_json_matches_process_files(slice_run, capsys):
    """The port's CLI, reference argument contract, on the same files."""
    _, rt, _, files = slice_run
    rc = port_cli.main([str(OMAHA["ref_freq"]), str(OMAHA["tgt_freq"]), CSV,
                        *files, "--max-lag", "512", "--device", "cpu",
                        "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(out["tdoa_us"], rt.tdoa_seconds * 1e6,
                               atol=1e-9)
    assert out["stations"] == rt.station_names


@pytest.mark.parametrize("flag", [["--profile"], ["--trace", "trace-dir"]])
def test_cli_rejects_unported_flags(flag, tmp_path, capsys):
    """The two flags the CLI once rejected as unported now run:
    ``--profile`` prints the stage timings to stderr, ``--trace DIR``
    writes a ``torch.profiler`` Chrome trace into DIR."""
    n = 1 << 16
    x = fm_block(3, 3 * n, (0.0, 3.5, -7.25), seed=21)
    files = []
    for s, name in enumerate(OMAHA["names"]):
        z = (x[0, s] + 1j * x[1, s]).astype(np.complex64)
        files.append(str(tmp_path / f"sim-{name}-1.dat"))
        save_dat(files[-1], z[:n], z[n:2 * n], z[2 * n:])
    if flag[0] == "--trace":
        flag = ["--trace", str(tmp_path / flag[1])]
    rc = port_cli.main([str(OMAHA["ref_freq"]), str(OMAHA["tgt_freq"]), CSV,
                        *files, "--max-lag", "512", "--device", "cpu", *flag])
    assert rc == 0
    err = capsys.readouterr().err
    if flag[0] == "--profile":
        report = err.split("stage timings:\n", 1)[1]
        for stage in ("total", "load+decode", "correlate+clock", "solve"):
            assert stage in report
    else:
        (trace,) = Path(flag[1]).glob("trace-*.json")
        assert json.loads(trace.read_text())["traceEvents"]


def test_batch_route_is_decided_once_per_stations_and_card(monkeypatch):
    """``load_files`` (decode dtype) and ``process_captures``
    (accumulator) ask ``_fused_eligible`` at different free memory: the
    card's verdict is taken once per (stations, block length, card) and
    both calls — of any processor — get it, even when the free memory
    would now say otherwise."""
    from tdoa_tpu_torch.ops.kernels import corr_accum
    from tdoa_tpu_torch.pipeline import processor as tproc

    free = iter([80 << 30, 0, 0])
    asked = []

    def launch_bytes(n_st, pairs, sums, banks, device, n_seg):
        asked.append((n_st, [tuple(p) for p in pairs.tolist()], sums, banks,
                      device, n_seg))
        return 1 << 20

    monkeypatch.setattr(corr_accum, "launch_bytes", launch_bytes)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (next(free), 80 << 30))
    tproc._BATCH_ROUTES.clear()
    try:
        procs = [TDOAProcessor.from_csv(OMAHA["ref_freq"], OMAHA["tgt_freq"],
                                        CSV, device="cpu") for _ in range(2)]
        for p in procs:  # the card's verdict, without touching a card
            p.device = torch.device("cuda", 0)
        as_load_files = procs[0]._fused_eligible(3, BLOCK)
        as_process_captures = procs[0]._fused_eligible(3, BLOCK)
        assert as_load_files is as_process_captures is True
        assert procs[1]._fused_eligible(3, BLOCK) is True
        assert asked == [(3, [(0, 1), (0, 2), (1, 2)], True, 4,
                          torch.device("cuda", 0), BLOCK // 45056)]
        # Off the kernel's geometry no card is asked at all.
        assert procs[0]._fused_eligible(3, 1000) is False
        assert len(asked) == 1
    finally:
        tproc._BATCH_ROUTES.clear()


def test_process_captures_asks_the_route_holding_its_stacks(slice_run,
                                                           monkeypatch):
    """``load_files`` asks the batch route's gate before it decodes, and
    ``process_captures`` asks it holding its stacks, of their dtype: so
    where ``process_captures`` asks first, with the captures already on
    the card, the verdict counts them and the stacks as allocated and
    not again as needed."""
    *_, files = slice_run
    asked = []
    eligible = TDOAProcessor._fused_eligible

    def spy(self, n_stations, min_block_samples, staged=None):
        asked.append((n_stations, min_block_samples, staged))
        return eligible(self, n_stations, min_block_samples, staged)

    monkeypatch.setattr(TDOAProcessor, "_fused_eligible", spy)
    proc = TDOAProcessor.from_csv(OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV,
                                  device="cpu", max_lag=512)
    res = proc.process_captures(proc.load_files(files))
    assert asked == [(3, BLOCK, None), (3, BLOCK, torch.bfloat16)]
    assert np.isfinite(res.corrected_tdoa_samples).all()


def test_port_imports_without_jax():
    """tdoa_tpu_torch never imports jax or tdoa_tpu: every module imports
    in a process where both are blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tdoa_tpu'] = None\n"
        "import importlib, pkgutil, tdoa_tpu_torch\n"
        "for m in pkgutil.walk_packages(tdoa_tpu_torch.__path__,"
        " 'tdoa_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tdoa_tpu' or m.startswith('tdoa_tpu.')]\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
    assert torch.__version__  # the port's one framework


@pytest.mark.cuda
def test_cuda_path_matches_cpu_path(cuda_sm90):
    """process_captures on the card (both CUDA kernels) against the same
    captures on CPU tensors (their plain versions): corrected TDOAs
    within 1e-3 samples, σs within 1e-3 relative, one launch of each
    kernel per block."""
    from tdoa_tpu_torch.ops.kernels.corr_accum import accumulate_banks
    from tdoa_tpu_torch.ops.kernels.zoom_probe import loo_zoom_windows

    n = 12 * 45056
    delays = {"ref": [0.0, -62.3, 95.7], "tgt": [0.0, 40.4, -41.6]}
    blocks = [fm_block(3, n, delays[k], seed=s)
              for s, k in enumerate(("ref", "tgt", "ref"))]
    caps = {name: tuple((b[0, st] + 1j * b[1, st]).astype(np.complex64)
                        for b in blocks)
            for st, name in enumerate(OMAHA["names"])}
    res = {}
    counts = (accumulate_banks.launches, loo_zoom_windows.launches)
    for dev in (cuda_sm90, torch.device("cpu")):
        res[dev.type] = TDOAProcessor.from_csv(
            OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV, device=dev,
            max_lag=512).process_captures(caps)
    assert accumulate_banks.launches == counts[0] + 3
    assert loo_zoom_windows.launches == counts[1] + 3
    np.testing.assert_allclose(res["cuda"].corrected_tdoa_samples,
                               res["cpu"].corrected_tdoa_samples, atol=1e-3)
    np.testing.assert_allclose(res["cuda"].tdoa_std_s, res["cpu"].tdoa_std_s,
                               rtol=1e-3)
