"""LO compensation, CAF/velocity and the FDOA ghost evidence of the
port's processor against ``tdoa_tpu`` on the scenes of
``tests/test_fdoa.py`` and the Monte Carlo FDOA-ghost regression
(``tests/test_monte_carlo.py``), simulated by the JAX package.

Each scene runs once per package in a module fixture: ``tdoa_tpu``
off the TPU (its segmented XLA correlator), the port on CPU tensors
with ``accumulator="xla"`` (the same path) — except ``lo_velocity``,
which holds the port's fused path (kernels 1 and 2's plain versions,
bf16 operands) to ``tdoa_tpu``'s Pallas kernels in interpret mode.
Tolerances: corrected TDOAs within 5e-3 samples, σ within 5 %,
``fdoa_hz`` within 0.05 Hz, velocity within 0.5 m/s, the fix inside
the JAX fix's 1σ ellipse, the same warnings word for word.
"""

import os
import re
import types

import numpy as np
import pytest

from tdoa_tpu_torch.geo import lla_to_enu

from _torch_port_helpers import (  # noqa: F401
    assert_warnings_match,
    cuda_sm90,
    fix_error_m,
    fix_offset_sigmas,
    run_both,
    tables,
)

try:  # the card's machine has no JAX: there only the `cuda` tests run
    from tdoa_tpu.sim import NoiseProfile
    from tdoa_tpu.sim.scene import SimScene
except ModuleNotFoundError:
    pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("kx0u", "n3pay", "kf0mtl")
LLA = np.array([
    [41.18660274289527, -95.96064116595667, 355.69],
    [41.24669616513154, -96.08366304481238, 329.0],
    [41.32916620016985, -96.03513381562004, 373.18],
])
REF_TX = np.array([41.25703803095629, -95.95512763589404, 349.07])
TGT = np.array([41.30888549464701, -96.02619229605524, 356.0])
VEL = np.array([120.0, -60.0, 0.0])
CLOCKS = np.array([5e-6, -9e-6, 14e-6])
DRIFTS = np.array([0.08, -0.05, 0.02])


def _scene(**kw):
    base = dict(station_names=NAMES, station_lla=LLA, ref_tx_lla=REF_TX,
                tgt_tx_lla=TGT, block_len=1 << 18, clock_offsets_s=CLOCKS)
    return SimScene(**{**base, **kw})


def _tdoa_truth(res, truth):
    tau = dict(zip(NAMES, truth.station_delays_samples[:, 1]))
    return np.array([tau[res.station_names[j]] - tau[res.station_names[i]]
                     for i, j in res.pair_idx])


def _load_mc():
    mc = types.ModuleType("mc")
    mc.__file__ = os.path.join(REPO, "scripts", "monte_carlo.py")
    src = open(mc.__file__).read().replace(
        'if __name__ == "__main__":\n    main()', '')
    exec(compile(src, "mc", "exec"), mc.__dict__)
    return mc


def _fdoa_ghost_scene():
    """Monte Carlo moving seed 1009: a ghost intersection that fits the
    TDOAs exactly and the Dopplers only with an absurd speed."""
    mc = _load_mc()
    rng = np.random.default_rng(1009)
    lla = mc.random_network(rng, 3)
    tgt = mc.random_target(rng, lla)
    speed = rng.uniform(30.0, 150.0)
    heading = rng.uniform(0.0, 2.0 * np.pi)
    vel = np.array([speed * np.cos(heading), speed * np.sin(heading), 0.0])
    return SimScene(
        station_names=("st0", "st1", "st2"), station_lla=lla,
        ref_tx_lla=mc.REF_TX, tgt_tx_lla=tgt, block_len=1 << 18, seed=1009,
        tgt_velocity_enu=vel, clock_offsets_s=rng.uniform(-20e-6, 20e-6, 3))


def _check_lo_velocity(rt, truth, sc, caps):
    """test_lo_compensation_with_velocity_no_double_correction."""
    assert any("LO offsets" in w for w in rt.warnings)
    assert np.linalg.norm(rt.velocity_enu - VEL) < 10.0


def _check_lo_drift(rt, truth, sc, caps):
    """test_lo_compensation_restores_drifting_clocks: the port without
    compensation misses by > 500 m, with it < 100 m."""
    from tdoa_tpu_torch.pipeline import ProcessorConfig, TDOAProcessor

    assert fix_error_m(rt.fix, TGT) < 100.0
    assert any("LO offsets" in w for w in rt.warnings)
    assert np.abs(rt.corrected_tdoa_samples
                  - _tdoa_truth(rt, truth)).max() < 0.5
    cfg = ProcessorConfig(ref_freq=sc.ref_freq, tgt_freq=sc.tgt_freq,
                          max_lag=512, accumulator="xla")
    off = TDOAProcessor(cfg, tables(NAMES, LLA, REF_TX)[1],
                        device="cpu").process_captures(caps)
    assert fix_error_m(off.fix, TGT) > 500.0


def _check_lo_disciplined(rt, truth, sc, caps):
    assert not any("LO offsets" in w for w in rt.warnings)


def _check_lo_prealigned(rt, truth, sc, caps):
    """test_lo_compensation_large_clock_offsets_prealigned."""
    assert any("LO offsets" in w for w in rt.warnings)
    assert not any("skipped" in w for w in rt.warnings)
    assert fix_error_m(rt.fix, TGT) < 100.0
    assert np.abs(rt.corrected_tdoa_samples
                  - _tdoa_truth(rt, truth)).max() < 0.5


def _check_lo_skipped(rt, truth, sc, caps):
    assert any("lo-compensation skipped" in w for w in rt.warnings)
    assert not any("LO offsets" in w for w in rt.warnings)


def _check_velocity_moving(rt, truth, sc, caps):
    """test_processor_solve_velocity_e2e, moving scene."""
    err = rt.velocity_enu - sc.tgt_velocity_enu
    assert np.linalg.norm(err) < 5.0
    assert np.all(np.abs(err[:2]) < 5.0 * rt.velocity_sigma_enu[:2] + 1.0)
    assert any("deramp-and-correlate" in w for w in rt.warnings)
    assert fix_error_m(rt.fix, TGT) < 150.0
    np.testing.assert_allclose(rt.fdoa_hz, truth.tgt_fdoa_hz, atol=1.0)


def _check_velocity_static(rt, truth, sc, caps):
    assert not any("deramp-and-correlate" in w for w in rt.warnings)
    assert np.linalg.norm(rt.velocity_enu) < 10.0


# name: (scene, processor settings, (jax accumulator, port accumulator),
# the reference test's bounds on the port's result)
SCENES = {
    "lo_velocity": (
        lambda: _scene(tgt_velocity_enu=VEL, clock_drifts_ppm=DRIFTS,
                       drift_doppler=True, seed=7),
        dict(max_lag=512, lo_compensation="auto", solve_velocity=True),
        ("pallas", "pallas"), _check_lo_velocity),
    "lo_drift": (
        lambda: _scene(clock_drifts_ppm=DRIFTS, drift_doppler=True, seed=7),
        dict(max_lag=512, lo_compensation="auto"), ("auto", "xla"),
        _check_lo_drift),
    "lo_disciplined": (
        lambda: _scene(block_len=1 << 17, seed=7),
        dict(max_lag=512, lo_compensation="auto"), ("auto", "xla"),
        _check_lo_disciplined),
    "lo_prealigned": (
        lambda: _scene(clock_offsets_s=np.array([2.1e-3, -1.7e-3, 0.4e-3]),
                       clock_drifts_ppm=DRIFTS, drift_doppler=True, seed=7),
        dict(max_lag=12000, lo_compensation="auto"), ("auto", "xla"),
        _check_lo_prealigned),
    "lo_skipped": (
        lambda: _scene(clock_offsets_s=np.array([2.1e-3, -1.7e-3, 0.4e-3]),
                       ref_profile=NoiseProfile(signal_amplitude=0.01,
                                                noise_amplitude=0.5),
                       seed=3),
        dict(max_lag=12000, lo_compensation="auto"), ("auto", "xla"),
        _check_lo_skipped),
    "velocity_moving": (
        lambda: _scene(tgt_velocity_enu=np.array([150.0, -80.0, 0.0]),
                       seed=5),
        dict(max_lag=512, solve_velocity=True), ("auto", "xla"),
        _check_velocity_moving),
    "velocity_static": (
        lambda: _scene(block_len=1 << 17, seed=5),
        dict(max_lag=512, solve_velocity=True), ("auto", "xla"),
        _check_velocity_static),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def motion_run(request):
    make, cfg, (acc_j, acc_t), check = SCENES[request.param]
    sc = make()
    rj, rt, truth, caps = run_both(sc, cfg, acc_j, acc_t)
    return rj, rt, truth, sc, check, caps


def test_corrected_tdoas_match(motion_run):
    """Corrected and raw TGT TDOAs within 5e-3 samples (after LO
    compensation and any deramp adoption), same pairs."""
    rj, rt, *_ = motion_run
    assert rt.station_names == rj.station_names
    np.testing.assert_array_equal(rt.pair_idx, rj.pair_idx)
    np.testing.assert_allclose(rt.corrected_tdoa_samples,
                               rj.corrected_tdoa_samples, atol=5e-3)
    np.testing.assert_allclose(rt.tgt_delay_samples, rj.tgt_delay_samples,
                               atol=5e-3)


def test_sigmas_match(motion_run):
    """Composite 1σ within 10 %: where σ is ~0.01 sample (clean,
    deramped or LO-compensated blocks) the split σ — the spread of four
    bank delays — moves with the last bits of each bank's probe, and the
    fused path's bf16 operands add the known difference of ROADMAP.md's
    "Not faults"."""
    rj, rt, *_ = motion_run
    np.testing.assert_allclose(rt.tdoa_std_s, rj.tdoa_std_s, rtol=0.1)


def test_fdoa_and_velocity_match(motion_run):
    """Drift-corrected per-pair Doppler within 0.05 Hz, velocity within
    0.5 m/s, its 1σ within 5 %; both None without solve_velocity."""
    rj, rt, *_ = motion_run
    assert (rt.fdoa_hz is None) == (rj.fdoa_hz is None)
    assert (rt.velocity_enu is None) == (rj.velocity_enu is None)
    if rj.fdoa_hz is None:
        return
    np.testing.assert_allclose(rt.fdoa_hz, rj.fdoa_hz, atol=0.05)
    np.testing.assert_allclose(rt.velocity_enu, rj.velocity_enu, atol=0.5)
    np.testing.assert_allclose(rt.velocity_sigma_enu, rj.velocity_sigma_enu,
                               rtol=0.05, atol=1e-6)
    assert abs(rt.velocity_residual_hz - rj.velocity_residual_hz) < 0.05


def test_fix_inside_the_jax_ellipse(motion_run):
    rj, rt, *_ = motion_run
    assert fix_offset_sigmas(rt.fix, rj.fix) < 1.0


def test_warnings_and_ghost_verdict_match(motion_run):
    rj, rt, *_ = motion_run
    assert_warnings_match(rt.warnings, rj.warnings)
    assert (rt.ghost is None) == (rj.ghost is None)
    if rj.ghost is not None:
        assert (rt.ghost.best, rt.ghost.decided) == (rj.ghost.best,
                                                     rj.ghost.decided)
        assert set(rt.ghost.components) == set(rj.ghost.components)
    assert rt.emitters is None and rj.emitters is None


def test_port_meets_the_reference_bounds(motion_run):
    """The bounds the reference's own test holds ``tdoa_tpu`` to, on
    the port's result."""
    _, rt, truth, sc, check, caps = motion_run
    check(rt, truth, sc, caps)



@pytest.fixture(scope="module")
def ghost_runs():
    """The Monte Carlo ghost scene with FDOA disambiguation on and off."""
    sc = _fdoa_ghost_scene()
    return sc, {
        on: run_both(sc, dict(max_lag=512, solve_velocity=True,
                              fdoa_disambiguation=on))
        for on in (True, False)
    }


_FDOA_TEXT = re.compile(r"differential-Doppler consistency [^;]*")


def test_fdoa_ghost_evidence_moves_the_fix(ghost_runs):
    """FDOA disambiguation on: in both packages the speed barrier (107
    against 1955 m/s) decides for the physical intersection, with the
    same fit residuals and speeds; the fix lands on the moving
    emitter's midpoint position, inside the JAX fix's ellipse."""
    sc, runs = ghost_runs
    rj, rt, _, _ = runs[True]
    texts = [[m for w in r.warnings for m in _FDOA_TEXT.findall(w)]
             for r in (rj, rt)]
    assert len(texts[0]) == len(texts[1]) == 1
    assert "selects the primary solution" in texts[1][0]
    assert_warnings_match(texts[1], texts[0])
    assert (rt.ghost.best, rt.ghost.decided) == (rj.ghost.best,
                                                 rj.ghost.decided)
    np.testing.assert_allclose(rt.ghost.components["fdoa"],
                               rj.ghost.components["fdoa"], atol=0.5)
    assert fix_offset_sigmas(rt.fix, rj.fix) < 1.0
    np.testing.assert_allclose(rt.velocity_enu, rj.velocity_enu, atol=0.5)
    mid = sc.tgt_velocity_enu[:2] * (1.5 * sc.block_len / sc.sample_rate)
    tgt = sc.tgt_tx_lla
    err = np.linalg.norm(lla_to_enu(
        np.array([rt.fix.lat, rt.fix.lon, tgt[2]]), tgt)[:2] - mid)
    assert err < 50.0
    assert np.linalg.norm(rt.velocity_enu[:2]
                          - sc.tgt_velocity_enu[:2]) < 15.0


def test_fdoa_ghost_tie_without_disambiguation(ghost_runs):
    """``fdoa_disambiguation=False``: the two intersections fit the
    TDOAs equally (rms equal to the float32 digit), so which one the
    multistart solver ranks first is decided by rounding — the
    reference keeps the ghost 25 km away, the port's float32 LM the
    physical one (ROADMAP.md Queue 3). Both flag the fix as ambiguous
    between the same two candidates and abstain."""
    _, runs = ghost_runs
    rj, rt, _, _ = runs[False]
    for r in (rj, rt):
        assert any("ambiguous fix" in w and "abstaining" in w
                   for w in r.warnings)
        assert len(r.fix.candidates_lla) == 2
    for c in rt.fix.candidates_lla:
        assert min(np.linalg.norm(lla_to_enu(np.asarray(c), np.asarray(d))[:2])
                   for d in rj.fix.candidates_lla) < 1.0
    np.testing.assert_allclose(rt.corrected_tdoa_samples,
                               rj.corrected_tdoa_samples, atol=5e-3)
    np.testing.assert_allclose(rt.fdoa_hz, rj.fdoa_hz, atol=0.05)


def test_config_from_fields_carries_every_new_setting():
    """A JAX config with every CAF, LO, FDOA and association setting off
    its default builds the same port config, field for field."""
    import dataclasses

    from tdoa_tpu.pipeline import ProcessorConfig as JaxConfig
    from tdoa_tpu_torch import convert

    jcfg = JaxConfig(ref_freq=1.0, tgt_freq=2.0, multi_emitter=3,
                     emitter_tol_samples=2.5, solve_velocity=True,
                     caf_seg_len=1 << 12, caf_n_doppler=33,
                     caf_max_samples=1 << 20, lo_compensation="auto",
                     fdoa_disambiguation=False, max_emitter_speed_mps=300.0)
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def _moving_captures(n, vel_enu, seed=3):
    """{station: (ref1, tgt, ref2)} of ``lat-lon-table.csv``'s stations:
    one wideband source per block, delayed by each station's geometry
    (the REF transmitter's on REF blocks, KEVO's on TGT) plus clock
    offsets of 24 / −62 / 96 samples, TGT shifted by the Doppler of an
    emitter moving at ``vel_enu`` (ENU at KEVO, m/s)."""
    from _torch_port_helpers import noise_block
    from tdoa_tpu_torch.geo import lla_to_ecef
    from tdoa_tpu_torch.io.stations import load_station_table

    table = load_station_table(os.path.join(REPO, "lat-lon-table.csv"),
                               reference_freq=162.4e6)
    st_lla = table.lla_array(NAMES)
    kevo = table["KEVO"].lla()
    st = lla_to_ecef(st_lla)

    def delays(tx):
        return np.linalg.norm(st - lla_to_ecef(tx), axis=-1) / 299792458.0 \
            * 2e6 + np.array([24.0, -62.0, 96.0])

    ref_d, tgt_d = delays(table.reference_tx.lla()), delays(kevo)
    blocks = [noise_block(3, n, d - d.min(), seed=seed + k)
              for k, d in enumerate((ref_d, tgt_d, ref_d))]
    u = lla_to_enu(st_lla, kevo)
    u = u / np.linalg.norm(u, axis=-1, keepdims=True)
    station_hz = -101.9e6 * (-(u @ np.asarray(vel_enu))) / 299792458.0
    t = np.arange(n) / 2e6
    tgt = blocks[1][0] + 1j * blocks[1][1]
    tgt *= np.exp(2j * np.pi * station_hz[:, None] * t[None, :])
    blocks[1] = np.stack([tgt.real, tgt.imag]).astype(np.float32)
    return {name: tuple((b[0, s] + 1j * b[1, s]).astype(np.complex64)
                        for b in blocks)
            for s, name in enumerate(NAMES)}


@pytest.mark.cuda
def test_cuda_velocity_path_matches_cpu(cuda_sm90):
    """``lo_compensation="auto"``, ``solve_velocity`` and
    ``multi_emitter=2`` on the card (the fused kernels, the CAF's
    steering products, the deramp re-correlation through kernel 2)
    against the same captures on CPU tensors: corrected TDOAs within
    1e-3 samples, Dopplers within 1e-2 Hz, velocity within 0.1 m/s,
    the same warnings and emitter count."""
    import torch

    from tdoa_tpu_torch.ops.kernels.corr_accum import accumulate_banks
    from tdoa_tpu_torch.ops.kernels.zoom_probe import loo_zoom_windows
    from tdoa_tpu_torch.pipeline import TDOAProcessor

    csv = os.path.join(REPO, "lat-lon-table.csv")
    caps = _moving_captures(12 * 45056, [120.0, -60.0, 0.0])
    res = {}
    counts = (accumulate_banks.launches, loo_zoom_windows.launches)
    for dev in (cuda_sm90, torch.device("cpu")):
        res[dev.type] = TDOAProcessor.from_csv(
            162.4e6, 101.9e6, csv, device=dev, max_lag=512,
            lo_compensation="auto", solve_velocity=True,
            multi_emitter=2).process_captures(caps)
    assert accumulate_banks.launches == counts[0] + 3
    assert loo_zoom_windows.launches >= counts[1] + 4  # + the deramp's
    c, p = res["cuda"], res["cpu"]
    assert any("deramp-and-correlate" in w for w in p.warnings)
    np.testing.assert_allclose(c.corrected_tdoa_samples,
                               p.corrected_tdoa_samples, atol=1e-3)
    np.testing.assert_allclose(c.fdoa_hz, p.fdoa_hz, atol=1e-2)
    np.testing.assert_allclose(c.velocity_enu, p.velocity_enu, atol=0.1)
    assert_warnings_match(c.warnings, p.warnings)
    assert len(c.emitters) == len(p.emitters)
