"""The CPU half of ``scripts/mesh_scaling_torch.py`` at a small size:
the sharded correlation on meshes of 1 and 2 gloo CPU ranks, each delay
within 1e-3 sample of the unsharded ``correlate_pairs`` (and of the
planted shifts)."""

import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


scaling = _load("mesh_scaling_torch")


def test_cpu_half_matches_the_unsharded_path(capsys):
    rows = scaling.cpu_half(1 << 18, (1, 2))
    out = capsys.readouterr().out
    assert [d for d, *_ in rows] == [1, 2]
    for d, wall, dev, err in rows:
        assert wall > 0
        assert dev < 1e-3, (d, dev)
        assert err < 1e-3, (d, err)
    assert "not a scaling figure" in out
    assert "| mesh d=2 |" in out


def test_no_card_means_the_cpu_half_alone(capsys, monkeypatch):
    """``--device cpu``: the CPU half, then the statement that the
    analytic half needs the card; exit 0."""
    monkeypatch.setattr(scaling, "cpu_half", lambda: [])
    assert scaling.main(["--device", "cpu"]) == 0
    assert "analytic half needs the card" in capsys.readouterr().out
