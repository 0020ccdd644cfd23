"""The ghost-posterior calibration harness on the port
(``scripts/ghost_calibration_torch.py``) against the reference's
(``scripts/ghost_calibration.py``), both run in process: ``analyze``'s
table and ``validate``'s line and exit code on the repository's seven
``GHOSTCAL_*.json`` artifacts, and a CPU ``gather`` whose records have
the reference's schema and replay to the same verdict through both
packages' ``ghost_posterior``."""

import argparse
import glob
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = sorted(glob.glob(os.path.join(REPO, "GHOSTCAL_*.json")))
RECORD_KEYS = {"cand_err_m", "cand_rms_m", "has_fdoa", "n_pairs_active",
               "n_stations", "power_scores", "regime", "seed", "sigma_m",
               "verdict"}
ARTIFACT_KEYS = {"seed_base", "trials_per_regime", "regimes", "n_trials",
                 "n_ghosts", "records"}
# Trial 0 of clean, noisy and moving at this base is a ghost-ambiguous
# 3-station geometry (outside the hull) on both packages' simulators.
GATHER_SEED = 42500


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


ref = _load("ghost_calibration")
port = _load("ghost_calibration_torch")


def _analyze(mod, capsys, artifacts):
    mod.analyze(argparse.Namespace(
        artifacts=artifacts, sigma_grid="0.15,0.2,0.25,0.35,0.5",
        thresh_grid="1.5,2.0,2.5,3.5,5.0"))
    return capsys.readouterr().out


def test_seven_artifacts_are_in_the_repository():
    assert len(ARTIFACTS) == 7


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_analyze_counts_equal_the_references(path, capsys):
    """Every grid point's four counts, per artifact."""
    got = _analyze(port, capsys, [path])
    want = _analyze(ref, capsys, [path])
    assert got == want
    assert len(got.strip().splitlines()) == 2 + 25


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_validate_line_and_exit_code_equal_the_references(path, capsys):
    args = argparse.Namespace(artifacts=[path])
    code = port.validate(args)
    got = capsys.readouterr().out
    with pytest.raises(SystemExit) as done:
        ref.validate(args)
    assert code == done.value.code
    assert got == capsys.readouterr().out
    assert port.main(["validate", path]) == code
    capsys.readouterr()


def test_cpu_gather_writes_the_reference_schema(tmp_path, capsys):
    """One trial a regime on the CPU: the artifact and its records have
    the reference's keys; every record replays, at the frozen constants,
    to the verdict the processor reported, through the port's and the
    reference's ``ghost_posterior`` alike; the reference's analyze reads
    it."""
    from tdoa_tpu.solve import ghost as jghost
    from tdoa_tpu_torch.solve import ghost as tghost

    out = tmp_path / "gc.json"
    assert port.main(["gather", "--seed", str(GATHER_SEED), "--trials", "1",
                      "--device", "cpu", "--out", str(out)]) == 0
    capsys.readouterr()
    data = json.loads(out.read_text())
    assert set(data) == ARTIFACT_KEYS
    assert data["n_trials"] == len(port.REGIMES)
    assert data["n_ghosts"] == len(data["records"]) >= 2
    for rec in data["records"]:
        assert set(rec) == RECORD_KEYS
        v = rec["verdict"]
        best, margin, decided = port.replay(
            rec, tghost.POWER_LOG_SIGMA, tghost.DECISION_THRESHOLD_NATS)
        assert (best, decided) == (v["best"], v["decided"])
        # The artifact rounds the margin and the components to 3 decimals.
        np.testing.assert_allclose(margin, v["margin_nats"], atol=2e-3)
        assert ref.replay(rec, jghost.POWER_LOG_SIGMA,
                          jghost.DECISION_THRESHOLD_NATS) == (
            best, margin, decided)
    assert _analyze(ref, capsys, [str(out)]) == _analyze(port, capsys,
                                                         [str(out)])
