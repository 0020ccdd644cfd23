"""The port's station tools (``tdoa_tpu_torch/cli/``: analyzer,
fast_analyzer, reader, snr_analysis, coverage, collector,
gain_calibrator, simple_corr, correlation_sanity) against the reference
CLIs on the same small files: the reference on the CPU, the port with
``--device cpu`` (``--torch-device cpu`` for the collector and the gain
calibrator, whose ``--device`` is the USB dongle index).

Exit codes equal; text equal with the numbers taken out, and each number
within one unit of its last printed digit (metrics that agree within
1e-3 dB or 1e-5 relative can print one digit apart); ``snr_analysis``
byte for byte; the ``coverage`` CSV within 1e-9 relative.
"""

import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import fm_block

try:  # the card's machine has no JAX
    from tdoa_tpu.cli import analyzer as j_analyzer
    from tdoa_tpu.cli import collector as j_collector
    from tdoa_tpu.cli import correlation_sanity as j_sanity
    from tdoa_tpu.cli import coverage as j_coverage
    from tdoa_tpu.cli import fast_analyzer as j_fast
    from tdoa_tpu.cli import gain_calibrator as j_gain
    from tdoa_tpu.cli import reader as j_reader
    from tdoa_tpu.cli import snr_analysis as j_snr
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.cli import analyzer as t_analyzer
from tdoa_tpu_torch.cli import collector as t_collector
from tdoa_tpu_torch.cli import correlation_sanity as t_sanity
from tdoa_tpu_torch.cli import coverage as t_coverage
from tdoa_tpu_torch.cli import fast_analyzer as t_fast
from tdoa_tpu_torch.cli import gain_calibrator as t_gain
from tdoa_tpu_torch.cli import reader as t_reader
from tdoa_tpu_torch.cli import simple_corr as t_simple
from tdoa_tpu_torch.cli import snr_analysis as t_snr
from tdoa_tpu_torch.io.datfile import save_dat

REPO = Path(__file__).resolve().parents[1]
CSV = str(REPO / "lat-lon-table.csv")
BLOCK = 1 << 16
_NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _unit(token: str) -> float:
    """One unit of a printed number's last digit."""
    mant, _, exp = token.partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (-decimals + (int(exp) if exp else 0))


def assert_same_text(got: str, want: str):
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl), (got, want)
    for a, b in zip(gl, wl):
        assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
        for x, y in zip(_NUM.findall(a), _NUM.findall(b)):
            assert abs(float(x) - float(y)) <= 1.001 * _unit(y), (a, b)


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _blocks(amps, seed, n=BLOCK, dc=0.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return [(a * np.exp(2j * np.pi * 0.07 * t) + dc + 0.01 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ).astype(np.complex64) for a in amps]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A good capture; one with a clipping TGT and a DC-biased REF; one
    truncated by a byte (tones over noise); a wideband FM-like capture
    (a tone's self-correlation has no unique peak)."""
    d = tmp_path_factory.mktemp("tools")
    out = {}
    for name, blocks in (("good", _blocks((0.4, 0.2, 0.4), 1)),
                         ("impaired", _blocks((0.3, 1.3, 0.3), 2, dc=0.1)),
                         ("truncated", _blocks((0.4, 0.2, 0.4), 3))):
        path = d / f"kx0u-{name}.dat"
        save_dat(str(path), *blocks)
        out[name] = str(path)
    data = Path(out["truncated"]).read_bytes()
    Path(out["truncated"]).write_bytes(data[:-1])
    x = fm_block(1, 3 * BLOCK, (0.0,), seed=4)[:, 0]
    z = (x[0] + 1j * x[1]).astype(np.complex64)
    out["wideband"] = str(d / "kx0u-wideband.dat")
    save_dat(out["wideband"], z[:BLOCK], z[BLOCK:2 * BLOCK], z[2 * BLOCK:])
    return out


@pytest.mark.parametrize("name", ["good", "impaired", "truncated"])
def test_analyzer_matches(files, capsys, name):
    rj, oj = _run(j_analyzer.main, [files[name], "--nfft", "4096"], capsys)
    rt, ot = _run(t_analyzer.main, [files[name], "--nfft", "4096",
                                    "--device", "cpu"], capsys)
    assert rt == rj
    assert_same_text(ot, oj)
    assert rj == (0 if name != "impaired" else 1)


@pytest.mark.parametrize("extra", [[], ["--max-samples", "4097",
                                        "--nfft", "1024"]])
@pytest.mark.parametrize("name", ["good", "impaired"])
def test_fast_analyzer_matches(files, capsys, name, extra):
    """The CSV contract: the same names and fractions, SNR and power to
    the last printed digit (defaults: 32768 samples, 8192 bins)."""
    rj, oj = _run(j_fast.main, [files[name], *extra], capsys)
    rt, ot = _run(t_fast.main, [files[name], *extra, "--device", "cpu"],
                  capsys)
    assert rt == rj == 0
    assert_same_text(ot, oj)
    for a, b in zip(ot.splitlines(), oj.splitlines()):
        fa, fb = a.split(","), b.split(",")
        assert (fa[0], fa[3], fa[4]) == (fb[0], fb[3], fb[4])


@pytest.mark.parametrize("name,expected", [
    ("good", None), ("good", str(3 * BLOCK / 2e6)), ("good", "1.0"),
    ("impaired", None), ("truncated", None),
])
def test_reader_matches(files, capsys, name, expected):
    argv = [files[name]] + ([expected] if expected else [])
    rj, oj = _run(j_reader.main, argv, capsys)
    rt, ot = _run(t_reader.main, [*argv, "--device", "cpu"], capsys)
    assert rt == rj
    assert_same_text(ot, oj)
    assert rj == (0 if name == "good" and expected != "1.0" else 1)


@pytest.mark.parametrize("argv", [
    [], ["--powers", "a=1e-3", "b=2.5e-5"], ["--noise-floor-db", "-60"],
])
def test_snr_analysis_stdout_is_byte_identical(capsys, argv):
    assert _run(t_snr.main, argv, capsys) == _run(j_snr.main, argv, capsys)


@pytest.mark.parametrize("argv", [
    ["--n", "11"],
    ["--n", "9", "--tdoa-sigma-us", "0.25", "--stations", "kx0u", "n3pay",
     "kf0mtl"],
    ["--n", "7", "--grid", "41.0", "-96.3", "41.5", "-95.8"],
])
def test_coverage_matches(capsys, tmp_path, argv):
    rj, oj = _run(j_coverage.main, [CSV, *argv, "--csv-out",
                                    str(tmp_path / "j.csv")], capsys)
    rt, ot = _run(t_coverage.main, [CSV, *argv, "--csv-out",
                                    str(tmp_path / "t.csv")], capsys)
    assert rt == rj == 0
    assert ot.replace("t.csv", "j.csv") == oj
    cj = np.genfromtxt(tmp_path / "j.csv", delimiter=",", skip_header=1)
    ct = np.genfromtxt(tmp_path / "t.csv", delimiter=",", skip_header=1)
    np.testing.assert_allclose(ct, cj, rtol=1e-9)


def test_coverage_rejects_what_the_reference_rejects(capsys):
    for argv in (["--stations", "nope"], ["--stations", "kx0u", "n3pay"]):
        rj = j_coverage.main([CSV, *argv])
        ej = capsys.readouterr().err
        rt = t_coverage.main([CSV, *argv])
        assert (rt, capsys.readouterr().err) == (rj, ej) and rj == 2


def test_collector_sim_writes_and_validates_a_window(tmp_path, capsys):
    """``--backend sim --duration 1``: the port's simulator makes all
    three stations, one is written as ``{station}-{epoch}.dat`` and
    passes the window's validation."""
    rc, out = _run(t_collector.main, [
        "162400000", "101900000", "1700000000", "n3pay", "--backend", "sim",
        "--duration", "1", "--torch-device", "cpu", "--out", str(tmp_path)],
        capsys)
    assert rc == 0, out
    path = tmp_path / "n3pay-1700000000.dat"
    assert path.stat().st_size == 2 * 3 * (2_000_000 // 3)
    assert "Validated: 1,999,998 samples" in out


def test_next_epoch_grid_equals_the_references():
    for epoch, interval, now in ((1000, 30, 999.0), (1000, 30, 1030.0),
                                 (1000, 30, 1095.5), (0, 7, 100.0),
                                 (1700000000, 32, 1700000100.2)):
        assert t_collector._next_epoch(epoch, interval, now) == \
            j_collector._next_epoch(epoch, interval, now)


@pytest.mark.parametrize("argv", [
    ["--tcp", "127.0.0.1:1234", "--ppm", "5", "--gain", "30.5"],
    ["--usb", "--device", "2", "--gain1", "12", "--gain2", "40",
     "--duration", "250"],
])
def test_collector_native_command_line_equals_the_references(
        monkeypatch, capsys, tmp_path, argv):
    """The native backend runs the same ``capture/build/sdr_capture``
    command line (the tool fails here: the exit code passes through)."""
    calls = []

    def fake_call(cmd):
        calls.append(cmd)
        return 3

    monkeypatch.setattr(subprocess, "call", fake_call)
    base = ["162400000", "101900000", "1700000000", "kx0u", "--backend",
            "native", "--out", str(tmp_path), *argv]
    rj, oj = _run(j_collector.main, base, capsys)
    rt, ot = _run(t_collector.main, [*base, "--torch-device", "cpu"], capsys)
    assert rt == rj == 3 and ot == oj
    assert calls[0] == calls[1]
    assert calls[1][0] == str(REPO / "capture" / "build" / "sdr_capture")


def test_gain_calibrator_sim_matches(capsys):
    """Both frequencies against the simulated receiver: the same search,
    SNRs to the last printed digit; the recommended command names the
    port's collector."""
    argv = ["162400000", "101900000", "--backend", "sim"]
    rj, oj = _run(j_gain.main, argv, capsys)
    rt, ot = _run(t_gain.main, [*argv, "--torch-device", "cpu"], capsys)
    assert rt == rj == 0
    assert "python -m tdoa_tpu_torch.cli.collector --gain1" in ot
    assert_same_text(ot.replace("tdoa_tpu_torch.cli", "tdoa_tpu.cli"), oj)
    assert ot.count("(converged,") == 2


def test_simple_corr_passes(capsys):
    """At half the default length (at 8192 samples the 100-sample circular
    delay wraps enough that both packages sit on the 0.05 bound)."""
    rc, out = _run(t_simple.main, ["--n", "16384", "--device", "cpu"], capsys)
    assert rc == 0 and out.count("PASS") == 4, out
    assert out.splitlines()[-1] == "ALL PASS"


def test_correlation_sanity_matches(files, capsys):
    rj, oj = _run(j_sanity.main, [files["wideband"]], capsys)
    rt, ot = _run(t_sanity.main, [files["wideband"], "--device", "cpu"],
                  capsys)
    assert rt == rj == 0 and ot.splitlines()[-1] == "PASS"
    assert_same_text(ot, oj)


@pytest.mark.parametrize("main,argv", [
    (t_analyzer.main, ["x.dat"]),
    (t_fast.main, ["x.dat"]),
    (t_reader.main, ["x.dat"]),
    (t_simple.main, []),
    (t_sanity.main, ["x.dat"]),
    (t_collector.main, ["1", "2", "0", "kx0u", "--backend", "sim"]),
    (t_gain.main, ["1", "2", "--backend", "sim"]),
], ids=["analyzer", "fast_analyzer", "reader", "simple_corr",
        "correlation_sanity", "collector", "gain_calibrator"])
def test_tools_without_a_card_exit_2_naming_the_cpu_flag(monkeypatch, capsys,
                                                         main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(argv) == 2
    err = capsys.readouterr().err
    flag = "--torch-device" if "--backend" in argv else "--device"
    assert "no CUDA device" in err and f"{flag} cpu" in err
