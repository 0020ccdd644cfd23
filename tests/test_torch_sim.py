"""The port's scene simulator (``tdoa_tpu_torch/sim``) and its CLIs
against ``tdoa_tpu.sim`` (CPU tensors on the port's side).

- ``compute_truth`` is numpy in both packages: equal, element for
  element.
- ``fractional_delay``, ``apply_channel`` and ``apply_channel_moving`` on
  one numpy input: within 1e-5 of the output's peak magnitude (the same
  float32 angle products; the FFTs sum in another order).
- JAX's random streams cannot be reproduced in torch, so each shaping
  step is held to the reference on the SAME numpy draw, handed to the
  JAX function in place of its ``jax.random`` draw: the brick-wall
  filter of ``bandlimited_noise`` within 1e-5 (unit RMS); the FM phase
  of ``fm_source`` within 1e-3 of the unit envelope (the two f32
  cumulative sums round differently over 2^15 samples: measured
  ~2e-5); the channel, noise, impulse, drift and DC terms of
  ``_receive_block`` within 1e-5 of the block's peak magnitude.
- A known-audio TGT block with no noise equals the reference's within
  1e-4 of its peak (same program, same channel).
- Scenes the port simulates go through the JAX processor and recover
  the truth within the bounds ``tests/test_pipeline.py`` holds the
  reference's own scenes to; the simulator CLIs' files are fixed by
  both packages' processors; ``caf_search`` prints the reference's peak
  on the same files.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import OMAHA_NAMES, fix_error_m, scene

try:  # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from tdoa_tpu.pipeline import TDOAProcessor as JaxProcessor
    from tdoa_tpu.sim import delay as jdelay
    from tdoa_tpu.sim import scene as jscene
    from tdoa_tpu.sim import source as jsource
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.pipeline import TDOAProcessor
from tdoa_tpu_torch.sim import delay as tdelay
from tdoa_tpu_torch.sim import scene as tscene
from tdoa_tpu_torch.sim import source as tsource

REPO = Path(__file__).resolve().parents[1]
CSV = str(REPO / "lat-lon-table.csv")
OMAHA = {
    "names": OMAHA_NAMES,
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
FS = 2e6
BLOCK = 1 << 17
CPU = torch.device("cpu")


def port_scene(js):
    """The port's SimScene with every field of the JAX one."""
    kw = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    for k in ("ref_profile", "tgt_profile"):
        kw[k] = tscene.NoiseProfile(**dataclasses.asdict(kw[k]))
    return tscene.SimScene(**kw)


def _peak_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- compute_truth ----------------------------------------------------

TRUTH_SCENES = {
    "static": dict(clock_offsets_s=np.array([12e-6, -31e-6, 48e-6])),
    "drifting_clocks": dict(
        clock_offsets_s=np.array([5e-6, -8e-6, 2e-6]),
        clock_drifts_ppm=np.array([0.2, -0.1, 0.05]), drift_doppler=True),
    "mover": dict(tgt_velocity_enu=np.array([120.0, -50.0, 3.0]),
                  clock_drifts_ppm=np.array([0.0, 0.3, -0.2])),
}


@pytest.mark.parametrize("name", list(TRUTH_SCENES))
def test_compute_truth_equals_the_reference(name):
    js = scene(OMAHA, 1 << 20, seed=0, **TRUTH_SCENES[name])
    want = jscene.compute_truth(js)
    got = tscene.compute_truth(port_scene(js))
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)


# ---- delays -----------------------------------------------------------

def _signal(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


DELAYS = np.array([0.0, 3.7, -12.25], np.float32)
RATES = np.array([2e-7, -4.5e-7, 1e-8], np.float32)
AMPS = np.array([1.0, 0.6, 0.35], np.float32)


@pytest.mark.parametrize("fn", ["fractional_delay", "apply_channel",
                                "apply_channel_moving"])
def test_delays_match_the_reference(fn):
    x = _signal()
    carrier = OMAHA["tgt_freq"]
    calls = {
        "fractional_delay": (
            lambda d, r, a: jdelay.fractional_delay(jnp.asarray(x), d),
            lambda: tdelay.fractional_delay(torch.from_numpy(x),
                                            torch.from_numpy(DELAYS))),
        "apply_channel": (
            lambda d, r, a: jdelay.apply_channel(jnp.asarray(x), d, carrier,
                                                 FS, a),
            lambda: tdelay.apply_channel(torch.from_numpy(x),
                                         torch.from_numpy(DELAYS), carrier,
                                         FS, torch.from_numpy(AMPS))),
        "apply_channel_moving": (
            lambda d, r, a: jdelay.apply_channel_moving(
                jnp.asarray(x), d, r, carrier, FS, a),
            lambda: tdelay.apply_channel_moving(
                torch.from_numpy(x), torch.from_numpy(DELAYS),
                torch.from_numpy(RATES), carrier, FS,
                torch.from_numpy(AMPS))),
    }
    jfn, tfn = calls[fn]
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(DELAYS), jnp.asarray(RATES),
                                    jnp.asarray(AMPS)))
    got = tfn().numpy()
    assert got.shape == want.shape == (3, x.size)
    assert _peak_err(got, want) < 1e-5
    if fn == "fractional_delay":  # one receiver at a time: the same row
        one = tdelay.fractional_delay(torch.from_numpy(x), float(DELAYS[1]))
        assert _peak_err(one.numpy(), want[1]) < 1e-5


# ---- shaping steps on one draw ---------------------------------------

class _Draws:
    """Stand-ins for the ``jax.random`` calls of one reference function,
    returning given numpy draws in call order (by name and shape)."""

    def __init__(self, monkeypatch, **draws):
        self.draws = {k: list(v) for k, v in draws.items()}
        for name in self.draws:
            monkeypatch.setattr(jax.random, name, self._make(name))

    def _make(self, name):
        def draw(key, *args, **kw):
            # normal/uniform(key, shape, ...), bernoulli(key, p, shape)
            shape = args[1] if name == "bernoulli" else args[0]
            v = self.draws[name].pop(0)
            assert tuple(v.shape) == tuple(shape), (name, v.shape, shape)
            return jnp.asarray(v)
        return draw


def test_brickwall_shaping_matches_bandlimited_noise(monkeypatch):
    x = np.random.default_rng(1).standard_normal(1 << 15).astype(np.float32)
    _Draws(monkeypatch, normal=[x])
    want = np.asarray(jsource.bandlimited_noise(jax.random.PRNGKey(0),
                                                x.size, 5e3, FS))
    got = tsource.brickwall(torch.from_numpy(x), 5e3, FS).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(float(np.std(got)) - 1.0) < 1e-5
    # the draw comes from the generator; the shaping is the same call
    g = torch.Generator().manual_seed(3)
    y = tsource.bandlimited_noise(4096, 5e3, FS, g)
    z = tsource.brickwall(torch.randn(4096, generator=torch.Generator()
                                      .manual_seed(3)), 5e3, FS)
    assert torch.equal(y, z)


def test_fm_phase_shaping_matches_fm_source(monkeypatch):
    x = np.random.default_rng(2).standard_normal(1 << 15).astype(np.float32)
    _Draws(monkeypatch, normal=[x])
    want = np.asarray(jsource.fm_source(jax.random.PRNGKey(0), x.size, FS))
    audio = tsource.brickwall(torch.from_numpy(x), 5e3, FS)
    got = tsource.fm_phase(audio, FS, 25e3).numpy()
    assert got.dtype == np.complex64
    assert np.abs(got - want).max() < 1e-3
    np.testing.assert_allclose(np.abs(got), 1.0, atol=1e-5)
    # tone_source: the same float32 angle product
    np.testing.assert_allclose(tsource.tone_source(5000, 1234.5, FS,
                                                   device=CPU).numpy(),
                               np.asarray(jsource.tone_source(5000, 1234.5,
                                                              FS)),
                               atol=1e-5)


RX_CASES = {
    "weak_ref_static": (
        dict(signal_amplitude=0.2, noise_amplitude=0.28, impulse_rate=0.001,
             impulse_amplitude=1.0, phase_drift_rad_s=0.05, dc_offset=0.05),
        False),
    "echo_moving_drift": (
        dict(noise_amplitude=0.02, multipath_amplitude=0.6,
             multipath_delay_samples=30.0, phase_drift_rad_s=-0.3,
             dc_offset=-0.01),
        True),
}


@pytest.mark.parametrize("case", list(RX_CASES))
def test_receive_block_shaping_matches_the_reference(monkeypatch, case):
    prof_kw, moving = RX_CASES[case]
    n_st, L = 3, 1 << 14
    rng = np.random.default_rng(5)
    src = np.exp(1j * np.cumsum(rng.standard_normal(L) * 0.3)).astype(
        np.complex64)
    delays = np.array([10.5, -62.25, 96.0], np.float32)
    amps = np.array([0.5, 0.4, 0.3], np.float32)
    rates = RATES if moving else None
    excess = np.array([30.5, 27.0, 33.25], np.float32)
    draws = {"noise": rng.standard_normal((2, n_st, L)).astype(np.float32)}
    jdraws = {"normal": [draws["noise"][0], draws["noise"][1]]}
    jprof = jscene.NoiseProfile(**prof_kw)
    if jprof.impulse_rate > 0:
        draws["hits"] = rng.random((n_st, L)) < 0.01
        draws["impulse_phase"] = (2 * np.pi * rng.random((n_st, L))).astype(
            np.float32)
        jdraws["bernoulli"] = [draws["hits"]]
        jdraws["uniform"] = [draws["impulse_phase"]]
    if jprof.phase_drift_rad_s != 0.0:
        draws["phase0"] = (2 * np.pi * rng.random((n_st, 1))).astype(
            np.float32)
        jdraws.setdefault("uniform", []).append(draws["phase0"])
    _Draws(monkeypatch, **jdraws)
    want = np.asarray(jscene._receive_block(
        jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(delays),
        jnp.asarray(amps), OMAHA["tgt_freq"], jprof, FS,
        multipath_excess=jnp.asarray(excess),
        delay_rates=None if rates is None else jnp.asarray(rates)))
    t = torch.from_numpy
    got = tscene._receive_block(
        t(src), t(delays), t(amps), OMAHA["tgt_freq"],
        tscene.NoiseProfile(**prof_kw), FS,
        {k: t(np.ascontiguousarray(v)) for k, v in draws.items()},
        multipath_excess=t(excess),
        delay_rates=None if rates is None else t(rates)).numpy()
    assert got.shape == want.shape == (n_st, L)
    assert _peak_err(got, want) < 1e-5


def test_draws_follow_the_profile():
    g = torch.Generator().manual_seed(0)
    d = tscene.draw_impairments(g, tscene.WEAK_REF_PROFILE, 3, 1 << 16)
    assert set(d) == {"noise", "hits", "impulse_phase", "phase0"}
    assert d["noise"].shape == (2, 3, 1 << 16)
    assert abs(float(d["hits"].float().mean()) - 1e-3) < 3e-4
    assert 0 <= float(d["impulse_phase"].min()) \
        and float(d["impulse_phase"].max()) < 2 * np.pi
    assert set(tscene.draw_impairments(g, tscene.IDEAL_PROFILE, 3, 8)) == {
        "noise"}


def test_known_audio_block_equals_the_reference():
    """No noise on TGT: the block is the program's FM envelope through
    the channel, in both packages."""
    audio = 0.5 * np.sin(2 * np.pi * 1e3 * np.arange(BLOCK // 2) / FS)
    js = scene(OMAHA, BLOCK, seed=3,
               clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]),
               tgt_audio=audio, tgt_deviation_hz=50e3,
               tgt_profile=jscene.NoiseProfile(noise_amplitude=0.0))
    jcaps, _ = jscene.simulate_scene(js)
    tcaps, _ = tscene.simulate_scene(port_scene(js), device=CPU)
    for n in OMAHA_NAMES:
        want = np.asarray(jcaps[n][1])
        got = tcaps[n][1].numpy()
        assert got.dtype == np.complex64 and got.shape == (BLOCK,)
        assert _peak_err(got, want) < 1e-4


# ---- the port's scenes through the JAX processor ---------------------

E2E = {
    # (scene settings, processor settings, TDOA bound, fix bound), the
    # bounds of the tests/test_pipeline.py case of the same scene
    "clock_offsets": (
        dict(clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]), seed=1),
        dict(seg_len=None, max_lag=512), 0.5, 200.0),
    "weak_signal": (
        dict(ref_profile="weak", tgt_profile="strong",
             clock_offsets_s=np.array([5e-6, -8e-6, 2e-6]), seed=7),
        dict(seg_len=1 << 15, max_lag=512), 3.5, 1500.0),
    "multipath": (
        dict(ref_profile="echo", tgt_profile="echo",
             clock_offsets_s=np.array([8e-6, -15e-6, 22e-6]), seed=13),
        dict(seg_len=1 << 15, max_lag=512), 3.0, 1500.0),
}


def _profiles(kw):
    named = {"weak": jscene.WEAK_REF_PROFILE,
             "strong": jscene.STRONG_TGT_PROFILE,
             "echo": jscene.NoiseProfile(multipath_amplitude=0.6,
                                         multipath_delay_samples=30.0)}
    return {k: named[v] if isinstance(v, str) else v for k, v in kw.items()}


@pytest.mark.parametrize("name", list(E2E))
def test_port_scenes_through_the_jax_processor(name):
    sc_kw, cfg, tdoa_tol, fix_tol = E2E[name]
    ts = port_scene(scene(OMAHA, BLOCK, **_profiles(sc_kw)))
    caps, truth = tscene.simulate_scene(ts, device=CPU)
    jp = JaxProcessor.from_csv(ts.ref_freq, ts.tgt_freq, CSV, **cfg)
    res = jp.process_captures({n: tuple(b.numpy() for b in caps[n])
                               for n in ts.station_names})
    np.testing.assert_allclose(res.corrected_tdoa_samples,
                               truth.tgt_tdoa_samples, atol=tdoa_tol)
    assert fix_error_m(res.fix, ts.tgt_tx_lla) < fix_tol
    # and through the port's own processor
    rt = TDOAProcessor.from_csv(ts.ref_freq, ts.tgt_freq, CSV, device=CPU,
                                **cfg).process_captures(caps)
    np.testing.assert_allclose(rt.corrected_tdoa_samples,
                               truth.tgt_tdoa_samples, atol=tdoa_tol)
    assert fix_error_m(rt.fix, ts.tgt_tx_lla) < fix_tol


def test_scene_is_seeded_and_the_interferer_adds_on_tgt():
    base = scene(OMAHA, 1 << 14, seed=4)
    a, _ = tscene.simulate_scene(port_scene(base), device=CPU)
    b, _ = tscene.simulate_scene(port_scene(base), device=CPU)
    assert all(torch.equal(x, y) for n in OMAHA_NAMES
               for x, y in zip(a[n], b[n]))
    c, _ = tscene.simulate_scene(
        port_scene(dataclasses.replace(base, interferer_lla=np.array(
            [41.36, -95.90, 340.0]), interferer_amplitude=0.5)), device=CPU)
    for n in OMAHA_NAMES:
        assert torch.equal(a[n][0], c[n][0])  # REF₁ drawn before TGT
        assert not torch.equal(a[n][1], c[n][1])


# ---- the CLIs --------------------------------------------------------

def _run_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


@pytest.mark.parametrize("cli", ["simulator", "weak_signal_simulator"])
def test_simulator_cli_files_are_fixed_by_both_processors(cli, tmp_path,
                                                          capsys):
    import importlib

    main = importlib.import_module(f"tdoa_tpu_torch.cli.{cli}").main
    out = _run_cli(main, ["--duration-s", "0.3", "--clock-offsets-us", "12",
                          "-31", "48", "--out", str(tmp_path), "--csv", CSV,
                          "--device", "cpu", "--seed", "2"], capsys)
    files = sorted(str(p) for p in tmp_path.glob("*.dat"))
    assert len(files) == 3
    assert "python -m tdoa_tpu_torch.cli.processor" in out
    prefix = "sim-" if cli == "simulator" else "weak-"
    assert all(Path(f).name.startswith(prefix) for f in files)
    lines = out.splitlines()
    first = lines.index("Ground truth TDOAs (samples):") + 1
    truth = {}
    for line in lines[first:first + 3]:  # "  kx0u-n3pay: -41.568"
        pair, v = line.strip().split(": ")
        truth[tuple(pair.split("-"))] = float(v)
    cfg = dict(seg_len=1 << 15, max_lag=512)
    tol, fix_tol = (0.5, 200.0) if cli == "simulator" else (3.5, 1500.0)
    for res in (JaxProcessor.from_csv(*FREQS, CSV, **cfg).process_files(files),
                TDOAProcessor.from_csv(*FREQS, CSV, device=CPU, **cfg)
                .process_files(files)):
        got = {}
        for (i, j), t in zip(res.pair_idx, res.corrected_tdoa_samples):
            a, b = res.station_names[i], res.station_names[j]
            got[(a, b)] = t
            got[(b, a)] = -t
        for k, v in truth.items():
            assert abs(got[k] - v) < tol, (k, got[k], v)
        assert fix_error_m(res.fix, OMAHA["tgt_tx_lla"]) < fix_tol



def test_caf_search_cli_matches_the_reference(tmp_path, capsys):
    from tdoa_tpu.cli import caf_search as jcli
    from tdoa_tpu_torch.cli import caf_search as tcli

    ts = port_scene(scene(OMAHA, 1 << 18, seed=6,
                          clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]),
                          tgt_velocity_enu=np.array([40.0, 0.0, 0.0])))
    paths, truth = tscene.write_scene_captures(ts, str(tmp_path), device=CPU)
    argv = [paths["kx0u"], paths["kf0mtl"]]
    want = _run_cli(jcli.main, argv, capsys)
    got = _run_cli(tcli.main, [*argv, "--device", "cpu"], capsys)
    peak = re.compile(r"peak: delay (\S+) samples .*Doppler (\S+) Hz, "
                      r"magnitude (\S+)")
    (dt, nt, mt), (dj, nj, mj) = [map(float, peak.search(o).groups())
                                  for o in (got, want)]
    assert abs(dt - dj) < 2e-3 and abs(nt - nj) < 1e-2
    assert abs(mt - mj) < 1e-3 * mj
    k = [tuple(p) for p in truth.pair_idx.tolist()].index((0, 2))
    assert abs(dt - truth.measured_tgt_delay[k]) < 0.5
    assert abs(nt - truth.tgt_fdoa_hz[k]) < 3.0
    assert "ambiguity surface" in got


def test_simulator_cli_without_a_card_is_an_error(tmp_path, capsys):
    from tdoa_tpu_torch.cli import simulator

    argv = ["--duration-s", "0.01", "--out", str(tmp_path)]
    if not torch.cuda.is_available():
        assert simulator.main(argv) == 2
        assert "no CUDA device" in capsys.readouterr().err
        assert not list(tmp_path.glob("*.dat"))
    assert simulator.main([*argv, "--device", "cpu"]) == 0
    assert len(list(tmp_path.glob("sim-*.dat"))) == 3
