"""The calibration gates on the port (``scripts/monte_carlo_torch.py``,
``scripts/ellipse_calibration_torch.py``): the reference's deterministic
Monte Carlo regressions (``tests/test_monte_carlo.py``) on the port's
own simulator and processor, both processors scored alike on the JAX
simulator's captures, and the sweeps on the CPU."""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch  # noqa: F401  (the port's processor runs on CPU tensors)

try:  # the card's machine has no JAX
    from tdoa_tpu.io.stations import Station as JStation
    from tdoa_tpu.io.stations import StationTable as JTable
    from tdoa_tpu.pipeline.processor import ProcessorConfig as JConfig
    from tdoa_tpu.pipeline.processor import TDOAProcessor as JProcessor
    from tdoa_tpu.sim.scene import NoiseProfile as JProfile
    from tdoa_tpu.sim.scene import SimScene as JScene
    from tdoa_tpu.sim.scene import simulate_scene as jax_simulate
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.geo import lla_to_enu
from tdoa_tpu_torch.pipeline.processor import ProcessorConfig, TDOAProcessor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # the ellipse script imports it by name
    spec.loader.exec_module(mod)
    return mod


mc = _load("monte_carlo_torch")


def _err_m(fix, tgt, mid_off=np.zeros(2)):
    return _cand_err((fix.lat, fix.lon), tgt, mid_off)


def _cand_err(lat_lon, tgt, mid_off=np.zeros(2)):
    """Horizontal distance, m, of a (lat, lon) from the target (less
    ``mid_off``, its ENU motion to the TGT block's midpoint)."""
    return float(np.linalg.norm(lla_to_enu(
        np.array([lat_lon[0], lat_lon[1], tgt[2]]), tgt)[:2] - mid_off))


def _run(trial, caps, **cfg):
    return TDOAProcessor(
        ProcessorConfig(ref_freq=162.4e6, tgt_freq=101.9e6,
                        **{**trial.config, **cfg}),
        trial.table(), device="cpu").process_captures(caps)


def _trial(regime, seed, accumulator="xla"):
    """A sweep trial on the port's simulator and processor on the CPU,
    scored. ``"xla"``: the segmented correlator, the route the
    reference's ``accumulator="auto"`` takes off the TPU, where its
    regressions were found; ``"auto"`` is the port's default (the kernel
    geometry wherever a block holds one of its segments)."""
    trial = mc.make_trial(regime, seed)
    trial.config["accumulator"] = accumulator
    caps, truth = mc.simulate(trial, "cpu")
    res = _run(trial, caps)
    return trial, caps, res, mc.score(trial, res, truth)


def test_ghost_ambiguity_is_flagged():
    """Clean seed 1112: an outside-the-hull emitter gives TWO exact
    hyperbola intersections. The result must carry the ambiguity
    warning, expose the true emitter among its candidates, rank it first
    by received power, and move there with power_disambiguation; the
    trial is never silent."""
    trial, caps, res, r = _trial("clean", 1112)
    assert r["tdoa_err"] < 0.1, r
    assert not r["silent"], r
    assert any("ambiguous fix" in w for w in res.warnings), res.warnings
    cand_errs = [_cand_err(c, trial.tgt) for c in res.fix.candidates_lla]
    assert min(cand_errs) < 30.0, cand_errs
    scores = res.fix.candidates_power_score
    assert scores is not None
    assert int(np.argmin(scores[:2])) == int(np.argmin(cand_errs))
    assert any("received-power ranking" in w for w in res.warnings)
    res2 = _run(trial, caps, power_disambiguation=True)
    assert _err_m(res2.fix, trial.tgt) < 30.0
    assert any("fix moved to the power-preferred" in w
               or "prefers the primary" in w for w in res2.warnings), \
        res2.warnings
    assert res2.fix.ellipse is not None


def test_short_blocks_take_the_segmented_route():
    """Pins a fault the calibration gates found (ROADMAP Queue 3): on
    2^17-sample blocks the kernel geometry holds 2 segments, the split
    σ's two banks one segment each (HT coherence identically 1), and σ
    came out over 10× the segmented route's. On the card that silenced
    the audio-match cross-validation warning (Monte Carlo audio-match
    seed 1008: a 12-sample miss, the reference flagged it on the same
    captures) and, on the CPU, the seed-1112 ghost warning. The default
    route now needs 8 kernel segments a block: on clean seed 1112 it is
    the segmented route, σ and warnings alike; the kernel route forced
    on these blocks still shows the degenerate σ."""
    trial, caps, res_seg, _ = _trial("clean", 1112, "xla")
    res_auto = _run(trial, caps, accumulator="auto")
    np.testing.assert_array_equal(res_auto.tdoa_std_s, res_seg.tdoa_std_s)
    assert any("ambiguous fix" in w for w in res_auto.warnings)
    res_k = _run(trial, caps, accumulator="pallas")
    assert np.all(res_k.tdoa_std_s > 10.0 * res_seg.tdoa_std_s), \
        (res_k.tdoa_std_s * 2e6, res_seg.tdoa_std_s * 2e6)
    assert not any("ambiguous fix" in w for w in res_k.warnings)
    proc = TDOAProcessor(ProcessorConfig(ref_freq=162.4e6, tgt_freq=101.9e6),
                         trial.table(), device="cpu")
    assert not proc._fused_eligible(3, 7 * 45056)
    assert proc._fused_eligible(3, 8 * 45056)


def test_bad_station_regime_excludes_corrupted_station():
    """Bad-station seed 1010: one of five stations has its TGT block
    shifted; leave-one-station-out rejection names exactly that station
    and the fix recovers on the healthy pairs, on either route."""
    for accumulator in ("xla", "auto"):
        _, _, _, r = _trial("bad-station", 1010, accumulator)
        assert r["excluded_right"] is True, r
        assert r["accurate"], r
        assert r["tdoa_err"] < 0.1, r
        assert r["fix_err"] < 50.0, r


def test_in_peak_multipath_is_flagged():
    """Multipath seed 6204: an echo inside the correlation peak's width
    merges with the direct path; the main-lobe centroid-drift detector
    must flag the miss, and must not fire on the clean twin of the same
    geometry."""
    _, _, _, r = _trial("multipath", 6204)
    assert not r["silent"], r
    assert r["warnings"] >= 1
    rng = np.random.default_rng(6204)
    lla = mc.random_network(rng, 3)
    tgt = mc.random_target(rng, lla)
    twin = mc.Trial(
        regime="clean", seed=6204, names=("st0", "st1", "st2"), lla=lla,
        tgt=tgt, scene={"block_len": 1 << 17,
                        "clock_offsets_s": rng.uniform(-50e-6, 50e-6, 3)},
        config={"max_lag": 768, "accumulator": "xla"}, atol_tdoa=0.5,
        atol_fix=200.0)
    caps, _ = mc.simulate(twin, "cpu")
    res = _run(twin, caps)
    assert not any("main lobe is asymmetric" in w for w in res.warnings), \
        res.warnings


def test_fdoa_disambiguation_resolves_moving_ghost():
    """Moving seed 1009: a ghost intersection 25 km away fits the TDOAs
    and the pairwise Dopplers, but only with an absurd velocity. The
    FDOA speed barrier selects the physical candidate, on either route.
    Turned off, the two intersections tie to the float32 digit: the
    fix is flagged ambiguous between them and abstains (the reference
    keeps the ghost there, the port's float32 solver the physical one:
    ROADMAP Queue 3)."""
    for accumulator in ("xla", "auto"):
        trial, caps, res_on, r = _trial("moving", 1009, accumulator)
        assert r["fix_err"] < 50.0, r["fix_err"]
        assert r["vel_err"] < 15.0, r["vel_err"]
        assert any("differential-Doppler consistency selects" in w
                   for w in res_on.warnings), res_on.warnings
        assert np.linalg.norm(res_on.velocity_enu[:2]
                              - trial.vel_true[:2]) < 15.0
    res_off = _run(trial, caps, fdoa_disambiguation=False)
    assert any("ambiguous fix" in w and "abstaining" in w
               for w in res_off.warnings), res_off.warnings
    errs = sorted(_cand_err(c, trial.tgt) for c in res_off.fix.candidates_lla)
    assert len(errs) == 2 and errs[0] < 50.0 and errs[1] > 10_000.0, errs


def _jax_scene(trial):
    kw = dict(trial.scene)
    for k in ("ref_profile", "tgt_profile"):
        if k in kw:
            kw[k] = JProfile(**dataclasses.asdict(kw[k]))
    return JScene(station_names=trial.names, station_lla=trial.lla,
                  ref_tx_lla=mc.REF_TX, tgt_tx_lla=trial.tgt,
                  seed=trial.seed, **kw)


@pytest.mark.parametrize("regime,t", [("clean", 0), ("clean", 1),
                                      ("noisy", 0), ("noisy", 1)])
def test_both_processors_score_alike_on_jax_captures(regime, t):
    """The JAX simulator's captures of a sweep trial through both
    processors on the CPU, both scored by the port's ``score``. The
    port runs the segmented correlator (``accumulator="xla"``), the
    reference's route off the TPU, so both transform in f32: the TDOA
    errors agree within 2e-3 samples, the fixes within 1 m, maha within
    10 % (the bound set for the split-σ difference between the TPU's
    bf16 DFT operands and the port's f32; on the CPU both are f32), and
    every verdict (accurate, flagged, covered, silent) is the same."""
    trial = mc.make_trial(regime, mc.trial_seed(regime, 1000, t))
    caps, truth = jax_simulate(_jax_scene(trial))
    caps = {n: caps[n] for n in trial.names}
    jtable = JTable(
        stations=[JStation(n, *trial.lla[k])
                  for k, n in enumerate(trial.names)],
        reference_tx=JStation("162400000", *mc.REF_TX))
    r_jax = JProcessor(JConfig(ref_freq=162.4e6, tgt_freq=101.9e6,
                               **trial.config), jtable).process_captures(caps)
    caps_np = {n: tuple(np.asarray(b) for b in caps[n]) for n in trial.names}
    r_port = _run(trial, caps_np, accumulator="xla")
    s_jax = mc.score(trial, r_jax, truth)
    s_port = mc.score(trial, r_port, truth)
    assert abs(s_port["tdoa_err"] - s_jax["tdoa_err"]) < 2e-3, \
        (s_port["tdoa_err"], s_jax["tdoa_err"])
    assert abs(s_port["fix_err"] - s_jax["fix_err"]) < 1.0
    assert s_port["maha"] == pytest.approx(s_jax["maha"], rel=0.1)
    for k in ("ok", "accurate", "silent", "warnings", "ambiguous"):
        assert s_port[k] == s_jax[k], (k, s_port[k], s_jax[k])


def test_ellipse_calibration_reports_and_gates(capsys):
    """The ellipse study at two trials a regime on the CPU: a coverage
    line per regime against chi(2), the pooled gate line, and an exit
    code that follows the printed pooled 3σ coverage."""
    ec = _load("ellipse_calibration_torch")
    rc = ec.main(["--trials", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    for regime in ec.REPORTED:
        assert out.count(f"{regime:12s} n=") == 1, out
    c3 = float(out.split("3σ coverage ")[-1].split("%")[0])
    assert "(gate: >= 90%)" in out
    assert rc == (0 if c3 >= 90.0 else 1), out


@pytest.mark.slow
def test_monte_carlo_torch_sweep_small():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "monte_carlo_torch.py"),
         "--trials-per-regime", "3", "--device", "cpu"],
        capture_output=True, text=True, timeout=3000,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-500:]
    assert "SILENT-FAIL" not in r.stdout
