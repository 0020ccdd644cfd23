"""The port's solver, capture codec and power estimators against
``tdoa_tpu`` on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import KEVO_LLA, NET24_LLA, pair_tdoas
from tdoa_tpu.geo import lla_to_ecef
from tdoa_tpu.io import datfile as jdat
from tdoa_tpu.ops.cplx import C
from tdoa_tpu.pipeline import processor as jproc
from tdoa_tpu.solve import multilateration as jml
from tdoa_tpu_torch.io import datfile as tdat
from tdoa_tpu_torch.pipeline import processor as tproc
from tdoa_tpu_torch.solve import multilateration as tml
from tdoa_tpu_torch.utils.constants import SPEED_OF_LIGHT


def _tdoas(omaha, tx_lla, noise_s, seed):
    rng = np.random.default_rng(seed)
    st = lla_to_ecef(omaha["station_lla"])
    d = np.linalg.norm(st - lla_to_ecef(tx_lla), axis=-1)
    pairs = jml.station_pairs(3)
    tdoa = (d[pairs[:, 1]] - d[pairs[:, 0]]) / SPEED_OF_LIGHT
    return tdoa + noise_s * rng.standard_normal(len(pairs))


@pytest.mark.parametrize("tx", ["tgt", "outside"])
def test_solve_fix_matches_jax(omaha_stations, tx):
    """float32 multistart LM, same starts and iterations: the fixes agree
    to 0.5 m (float32 rounding in two frameworks) and carry the same
    candidates, covariance and ellipse."""
    lla = omaha_stations["tgt_tx_lla"] if tx == "tgt" else np.array(
        [41.05, -96.30, 350.0])
    tdoa = _tdoas(omaha_stations, lla, 2e-9, seed=3)
    sig = np.full(3, 5e-9)
    w = np.array([1.0, 0.8, 0.6])
    kw = dict(weights=w, tdoa_sigma_s=sig)
    fj = jml.solve_fix(omaha_stations["station_lla"], tdoa, **kw)
    ft = tml.solve_fix(omaha_stations["station_lla"], tdoa, **kw)
    assert np.linalg.norm(ft.enu - fj.enu) < 0.5
    assert len(ft.candidates_lla) == len(fj.candidates_lla)
    np.testing.assert_allclose(ft.candidates_rms, fj.candidates_rms,
                               atol=0.05)
    np.testing.assert_allclose(ft.cov_en, fj.cov_en, rtol=1e-3)
    np.testing.assert_allclose(ft.ellipse, fj.ellipse, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("solve_z", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("tx", ["tgt", "outside"])
def test_solve_fix_matches_jax_at_24_stations(solve_z, tx):
    """276 pairs, weighted, in 2D and with the up-coordinate solved: the
    same candidates, the fix within 0.5 m and the candidates' rms within
    0.05 m. With ``solve_z`` the up-coordinate lies in a flat
    valley of the cost (the stations sit within 45 m of one another's
    height), where float32 rounding in two frameworks moves it by
    metres: the horizontal fix is held, and the covariance."""
    lla = np.array([41.05, -96.30, 350.0]) if tx == "outside" else KEVO_LLA
    tdoa = pair_tdoas(NET24_LLA, lla, 2e-9, seed=3)
    m = len(tdoa)
    w = np.random.default_rng(13).uniform(0.5, 1.0, m)
    kw = dict(weights=w, tdoa_sigma_s=np.full(m, 5e-9), solve_z=solve_z)
    fj = jml.solve_fix(NET24_LLA, tdoa, **kw)
    ft = tml.solve_fix(NET24_LLA, tdoa, **kw)
    n = 2 if solve_z else 3
    assert np.linalg.norm(ft.enu[:n] - fj.enu[:n]) < 0.5
    assert len(ft.candidates_lla) == len(fj.candidates_lla)
    np.testing.assert_allclose(ft.candidates_rms, fj.candidates_rms,
                               atol=0.05)
    np.testing.assert_allclose(ft.cov_en, fj.cov_en, rtol=1e-3)


def test_refit_and_power_ranking_match_jax(omaha_stations):
    tdoa = _tdoas(omaha_stations, np.array([41.05, -96.30, 350.0]), 0.0, 1)
    fj = jml.solve_fix(omaha_stations["station_lla"], tdoa,
                       tdoa_sigma_s=np.full(3, 5e-9))
    ft = tml.solve_fix(omaha_stations["station_lla"], tdoa,
                       tdoa_sigma_s=np.full(3, 5e-9))
    assert len(fj.candidates_lla) == len(ft.candidates_lla)
    powers = np.array([1.0, 0.4, 0.2])
    sj = jml.rank_candidates_by_power(fj.candidates_lla,
                                      omaha_stations["station_lla"], powers)
    st = tml.rank_candidates_by_power(ft.candidates_lla,
                                      omaha_stations["station_lla"], powers)
    np.testing.assert_allclose(st, sj, atol=1e-4)
    if len(fj.candidates_lla) > 1:
        rj = jml.refit_to_candidate(fj, 1, omaha_stations["station_lla"],
                                    tdoa_sigma_s=np.full(3, 5e-9))
        rt = tml.refit_to_candidate(ft, 1, omaha_stations["station_lla"],
                                    tdoa_sigma_s=np.full(3, 5e-9))
        assert abs(rt.lat - rj.lat) < 1e-5 and abs(rt.lon - rj.lon) < 1e-5
        np.testing.assert_allclose(rt.ellipse, rj.ellipse, rtol=1e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dat_decode_matches_jax(tmp_path, dtype):
    """save_dat → load_dat: the same bytes on disk, the same decoded
    samples and [REF | TGT | REF] split. bf16 is bit-identical; f32 is
    within 1 ulp (XLA:CPU divides by 127.5 as a reciprocal multiply,
    torch divides)."""
    rng = np.random.default_rng(0)
    blocks = [(0.4 * (rng.standard_normal(1000)
                      + 1j * rng.standard_normal(1000))).astype(np.complex64)
              for _ in range(3)]
    pj, pt = tmp_path / "a-jax.dat", tmp_path / "a-torch.dat"
    jdat.save_dat(str(pj), *(jnp.asarray(b) for b in blocks))
    tdat.save_dat(str(pt), *blocks)
    assert pj.read_bytes() == pt.read_bytes()
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    cj = jdat.load_dat(str(pj), dtype=jd)
    ct = tdat.load_dat(str(pt), dtype=td, device="cpu")
    ulp = 0.0 if dtype == "bf16" else 1.2e-7
    for name in ("ref1", "tgt", "ref2"):
        bj, bt = getattr(cj, name), getattr(ct, name)
        np.testing.assert_allclose(bt[0].float().numpy(),
                                   np.asarray(bj.re, np.float32), rtol=ulp)
        np.testing.assert_allclose(bt[1].float().numpy(),
                                   np.asarray(bj.im, np.float32), rtol=ulp)


def test_station_power_estimators_match_jax():
    """The received-power ghost ranking's inputs: mean power and the
    floor-subtracted Welch signal power."""
    rng = np.random.default_rng(2)
    n = 1 << 18
    t = np.arange(n)
    x = np.stack([a * np.exp(2j * np.pi * 0.01 * t)
                  + 0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
                  for a in (1.0, 0.5, 0.2)]).astype(np.complex64)
    xj = C(jnp.asarray(x.real), jnp.asarray(x.imag))
    xt = torch.stack([torch.from_numpy(x.real.copy()),
                      torch.from_numpy(x.imag.copy())])
    np.testing.assert_allclose(tproc._station_mean_power(xt),
                               jproc._station_mean_power(xj), rtol=1e-5)
    np.testing.assert_allclose(tproc._station_signal_power(xt),
                               jproc._station_signal_power(xj), rtol=1e-6)
