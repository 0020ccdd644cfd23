"""The heavy-tailed multipath calibration on the port
(``scripts/multipath_tailcal_torch.py``,
``scripts/multipath_fixcov_diag_torch.py``) against the reference's:
the port's ``fit`` over the repository's capture bases reproduces
``MULTIPATH_CAL_r05.json``; a CPU ``capture`` writes a base both
scripts read; the diag prints its γ table."""

import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAL = os.path.join(REPO, "calib_data")
FIT_BASES = [os.path.join(CAL, f"mp_base_{s}.npz")
             for s in (9000, 67000, 70000, 71000, 73000)]
HOLDOUT = os.path.join(CAL, "mp_base_78000.npz")
CAPTURE_SEED = 150000


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


ref = _load("multipath_tailcal")
port = _load("multipath_tailcal_torch")
diag = _load("multipath_fixcov_diag_torch")


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """(the port's fit artifact over the repository's bases, the shipped
    one)."""
    out = tmp_path_factory.mktemp("fit") / "fit.json"
    assert port.main(["fit", "--bases", *FIT_BASES, "--holdout", HOLDOUT,
                      "--json", str(out)]) == 0
    with open(os.path.join(REPO, "MULTIPATH_CAL_r05.json")) as f:
        return json.loads(out.read_text()), json.load(f)


def test_fit_reproduces_the_shipped_constants(fitted):
    """γ, ν, thresholds and contour scales to 1e-3; the pooled rows, the
    duplicates dropped, the engaged p50 and the pooled coverage
    exactly."""
    got, want = fitted
    assert set(got) == set(want)
    for key in ("gamma", "nu"):
        assert abs(got[key] - want[key]) < 1e-3
    for key in ("thresholds", "contour_scales"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-3)
    for key in ("pooled_unique_rows", "duplicate_seeds_dropped",
                "pooled_engaged_p50_maha", "pooled_coverage_pct",
                "pooled_n", "chi2_mass", "model"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("base", [os.path.basename(p)
                                  for p in FIT_BASES + [HOLDOUT]])
def test_fit_reproduces_each_base(fitted, base):
    """Each base's n, coverage at 1/2/3σ, engaged p50 and holdout flag
    exactly."""
    got, want = fitted
    assert set(got["bases"]) == set(want["bases"])
    assert got["bases"][base] == want["bases"][base]


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """A 2-trial CPU capture of the multipath regime."""
    out = tmp_path_factory.mktemp("mp") / "mp_base.npz"
    assert port.main(["capture", "--seed", str(CAPTURE_SEED), "--trials",
                      "2", "--device", "cpu", "--out", str(out)]) == 0
    return out


def test_capture_is_read_by_both_scripts(captured):
    """Both ``_load_base`` read the port's base alike, with the
    reference's fields; its engaged rows replay to a finite maha through
    both packages' covariance."""
    rows_t, ind_t = port._load_base(str(captured))
    rows_r, ind_r = ref._load_base(str(captured))
    assert ind_t == ind_r
    assert len(rows_t) == len(rows_r)
    assert len(rows_t) + len(ind_t) >= 1
    for a, b in zip(rows_t, rows_r):
        assert set(a) == set(b) >= {
            "seed", "err", "tau_raw", "gamma_eff", "confirmed",
            "stations_enu", "pair_idx", "pos_enu", "sigma_noise_m",
            "station_bias_m"}
        m_t, m_r = port._maha(a, 2.0), ref._maha(b, 2.0)
        assert np.isfinite(m_t)
        np.testing.assert_allclose(m_t, m_r, rtol=1e-9)


def test_diag_prints_the_gamma_table(capsys):
    """The diag over the same two trials: the trial counts, then one row
    of 1/2/3σ coverage and p50/p95 for each γ asked for."""
    assert diag.main(["--trials", "2", "--seed", str(CAPTURE_SEED),
                      "--gammas", "1.0,2.0,3.0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"\d+ correlated-path trials, \d+ independent-model "
                     r"trials", out)
    rows = [ln for ln in out.splitlines()
            if re.match(r"\s*[123]\.00 ", ln)]
    assert len(rows) == 3, out
    for ln in rows:
        assert ln.count("%") == 3 or "no correlated-path trial" in ln
