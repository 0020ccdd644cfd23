"""Capture quality, structural validation and gain calibration of the
port (``tdoa_tpu_torch/dsp/snr.py``, ``quality/``, ``calib/``) against
the JAX package on the same numpy-seeded inputs, the port on CPU tensors.

Tolerances: Welch PSD within 1e-4 of its peak bin and SNR within 1e-3 dB
(f32 FFTs in both, summed in another order); byte fractions, min/max
bytes and flags exactly equal (counts of the same bytes; over a block
length that is not a power of two a fraction may differ by one float32
ulp, the quotient rounded the other way); DC within 1e-4
bytes; power and RMS within 1e-5 relative; I/Q imbalance within 1e-4 dB
(float32 means of the same squares). A dead receiver's block is a
constant: its "noise" bins hold only the FFT's rounding, so where the
reference reads it above 120 dB the port is held to that, not to a digit.
"""

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX: there only the `cuda` tests run
    import jax.numpy as jnp
    from tdoa_tpu import calib as jcalib
    from tdoa_tpu import quality as jq
    from tdoa_tpu.dsp import snr as jsnr
    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.quality import analyzer as jqa
except ModuleNotFoundError:
    pass
from _torch_port_helpers import cuda_sm90  # noqa: F401
from tdoa_tpu_torch import calib as tcalib
from tdoa_tpu_torch import quality as tq
from tdoa_tpu_torch.dsp import snr as tsnr
from tdoa_tpu_torch.io.datfile import iq_to_bytes, save_dat
from tdoa_tpu_torch.quality import analyzer as tqa

BLOCK = 1 << 16  # samples per block of the test files
SNR_TOL_DB = 1e-3
FRACTIONS = ("clip_fraction", "overload_fraction", "dead_fraction")
FLAGS = ("is_clipping", "is_overloaded", "is_dead", "is_noisy")


def _tone(n=1 << 14, amp=0.5, noise=0.001, dc=0.0, seed=0):
    """The complex tone + noise of ``tests/test_quality.py``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = amp * np.exp(2j * np.pi * 0.11 * t) + noise * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (x + dc).astype(np.complex64)


def _dead(n_bytes=4096):
    raw = np.full(n_bytes, 127, np.uint8)
    raw[1::2] = 128
    return raw


BYTE_CASES = {
    "good tone": lambda: iq_to_bytes(_tone()),
    "clipping (amp 1.4)": lambda: iq_to_bytes(_tone(amp=1.4)),
    "dead 127/128": _dead,
    "DC 0.1+0.1j": lambda: iq_to_bytes(_tone(amp=0.3, dc=0.1 + 0.1j)),
    "weak": lambda: iq_to_bytes(_tone(amp=0.002, noise=0.02)),
    "uniform random bytes": lambda: np.random.default_rng(7).integers(
        0, 256, 1 << 15, dtype=np.uint8),
}


def assert_stats_match(st, sj, frac_rtol=0.0):
    """One block's metrics, port ``st`` against reference ``sj``.
    ``frac_rtol``: the fractions' tolerance (0: bitwise equal)."""
    for f in ("min_byte", "max_byte") + FLAGS:
        assert getattr(st, f) == getattr(sj, f), f
    for f in FRACTIONS:
        assert abs(getattr(st, f) - getattr(sj, f)) <= \
            frac_rtol * abs(getattr(sj, f)), f
    np.testing.assert_allclose([st.dc_offset_i, st.dc_offset_q],
                               [sj.dc_offset_i, sj.dc_offset_q], atol=1e-4)
    np.testing.assert_allclose([st.power, st.rms], [sj.power, sj.rms],
                               rtol=1e-5)
    assert abs(st.iq_imbalance_db - sj.iq_imbalance_db) < 1e-4
    if sj.is_dead and sj.snr_db > 120.0:
        assert st.snr_db > 120.0
    else:
        assert abs(st.snr_db - sj.snr_db) < SNR_TOL_DB


def _signal(shape, seed=3):
    """Complex64 tone + noise with a second weaker tone."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n)
    x = (0.4 * np.exp(2j * np.pi * 0.07 * t)
         + 0.05 * np.exp(-2j * np.pi * 0.21 * t)
         + 0.02 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
    return x.astype(np.complex64)


@pytest.mark.parametrize("shape,nfft,window", [
    ((3 * 8192 + 100,), 8192, "blackman_harris"),
    ((3 * 8192 + 100,), 8192, "hann"),
    ((3 * 8192 + 100,), 4096, "blackman_harris"),
    ((3 * 8192 + 100,), 4096, "hann"),
    ((3, 2 * 8192), 8192, "blackman_harris"),
    ((3, 2 * 8192), 8192, "hann"),
    ((3, 2 * 8192), 4096, "blackman_harris"),
    ((3, 2 * 8192), 4096, "hann"),
    ((3000,), 8192, "blackman_harris"),  # shorter than nfft: 2048 bins
    ((3, 5000), 4096, "hann"),
])
def test_psd_and_snr_match(shape, nfft, window):
    x = _signal(shape)
    xj = C(jnp.asarray(x.real), jnp.asarray(x.imag))
    pj = np.asarray(jsnr.psd_welch(xj, nfft=nfft, window=window))
    pt = tsnr.psd_welch(torch.from_numpy(x), nfft=nfft, window=window).numpy()
    assert pt.shape == pj.shape
    peak = np.abs(pj).max(axis=-1, keepdims=True)
    assert np.all(np.abs(pt - pj) <= 1e-4 * peak)
    sj = [np.asarray(v) for v in jsnr.spectral_snr(xj, nfft=nfft,
                                                    window=window)]
    st = [v.numpy() for v in tsnr.spectral_snr(torch.from_numpy(x),
                                                nfft=nfft, window=window)]
    np.testing.assert_allclose(st[0], sj[0], atol=SNR_TOL_DB)
    np.testing.assert_allclose(st[1:], sj[1:], rtol=1e-4)


@pytest.mark.parametrize("case", sorted(BYTE_CASES))
def test_block_metrics_match(case):
    raw = BYTE_CASES[case]()
    assert_stats_match(tq.analyze_block_bytes(raw, device="cpu"),
                       jq.analyze_block_bytes(raw))


def test_sim_backend_bytes_equal_the_references():
    """The simulated receiver draws and encodes exactly as the JAX
    package's: the calibrator's inputs are the same bytes."""
    for seed, freq, gain in ((0, 162.4e6, 25.0), (4, 101.9e6, 43.75)):
        a = tcalib.SimCaptureBackend(seed=seed).capture(freq, gain, 4096)
        b = np.asarray(jcalib.SimCaptureBackend(seed=seed).capture(
            freq, gain, 4096))
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- files


def _blocks(amps, seed, n=BLOCK, noise=0.01, dc=0.0):
    """Three complex blocks: a tone at each amplitude plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return [(a * np.exp(2j * np.pi * 0.07 * t) + dc + noise * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ).astype(np.complex64) for a in amps]


def _write(path, blocks, cut=0):
    save_dat(str(path), *blocks)
    if cut:
        data = path.read_bytes()
        path.write_bytes(data[:len(data) - cut])
    return str(path)


def _write_bytes(path, raw):
    path.write_bytes(raw.tobytes())
    return str(path)


FILES = {
    "good": lambda p: _write(p, _blocks((0.4, 0.2, 0.4), 1)),
    "one byte short": lambda p: _write(p, _blocks((0.4, 0.2, 0.4), 2), cut=1),
    "REF blocks 4x apart": lambda p: _write(p, _blocks((0.6, 0.2, 0.15), 3)),
    "TGT clipping, REF DC": lambda p: _write(
        p, _blocks((0.3, 1.3, 0.3), 4, dc=0.1)),
    "dead": lambda p: _write_bytes(p, _dead(6 * 4096)),
    "odd block length": lambda p: _write(p, _blocks((0.4, 0.2, 0.4), 5,
                                                   n=4099)),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("quality")
    return {k: make(d / f"kx0u-{i}.dat") for i, (k, make)
            in enumerate(sorted(FILES.items()))}


# The same count over a length that is not a power of two: the port
# divides it once, the reference's float32 mean may round its quotient
# the other way (one float32 ulp, 6e-8 relative).
FILE_FRAC_RTOL = 1.2e-7


def _assert_analysis_match(at, aj):
    assert_stats_match(at.ref, aj.ref, FILE_FRAC_RTOL)
    assert_stats_match(at.tgt, aj.tgt, FILE_FRAC_RTOL)
    assert at.path == aj.path
    assert at.suitable == aj.suitable


@pytest.mark.parametrize("budget", [1 << 21, 4099, 1])
@pytest.mark.parametrize("name", sorted(FILES))
def test_analyze_capture_matches(files, name, budget):
    """At the default budget (whole blocks here), a budget that is not a
    multiple of two IQ pairs (REF and TGT of different lengths), and one
    sample a block (one IQ pair a REF half)."""
    _assert_analysis_match(
        tq.analyze_capture(files[name], nfft=1024,
                           max_samples_per_block=budget, device="cpu"),
        jq.analyze_capture(files[name], nfft=1024,
                           max_samples_per_block=budget))


def test_analyze_capture_of_an_empty_file_raises_as_the_reference(tmp_path):
    path = tmp_path / "kx0u-0.dat"
    path.write_bytes(b"")
    with pytest.raises(ValueError):
        jq.analyze_capture(str(path))
    with pytest.raises(ValueError):
        tq.analyze_capture(str(path), device="cpu")


@pytest.mark.parametrize("expected_s", [None, 3 * BLOCK / 2e6, 1.0])
@pytest.mark.parametrize("name", sorted(FILES))
def test_validate_dat_structure_matches(files, name, expected_s):
    rt = tq.validate_dat_structure(files[name], expected_s, device="cpu")
    rj = jq.validate_dat_structure(files[name], expected_s)
    for f in ("path", "size_bytes", "samples_total", "samples_per_block",
              "three_block_pattern_ok", "duration_s", "expected_duration_ok",
              "ref_power_consistent", "problems"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert len(rt.block_stats) == len(rj.block_stats)
    for st, sj in zip(rt.block_stats, rj.block_stats):
        assert_stats_match(st, sj, FILE_FRAC_RTOL)


@pytest.mark.parametrize("size", [0, 4, 1000])
def test_validate_tiny_and_empty_files_match(tmp_path, size):
    path = tmp_path / "kf0mtl-3.dat"
    path.write_bytes(bytes(size))
    rt = tq.validate_dat_structure(str(path), device="cpu")
    rj = jq.validate_dat_structure(str(path))
    assert (rt.problems, rt.three_block_pattern_ok, len(rt.block_stats)) == \
        (rj.problems, rj.three_block_pattern_ok, len(rj.block_stats))


def _stats(**kw):
    base = dict(snr_db=30.0, power=0.1, rms=0.316, dc_offset_i=0.2,
                dc_offset_q=-0.1, iq_imbalance_db=0.05, clip_fraction=0.0,
                overload_fraction=0.0, dead_fraction=0.001, min_byte=20,
                max_byte=230)
    return {**base, **kw}


STATS = {
    "good": _stats(),
    "usable": _stats(snr_db=19.96),
    "weak": _stats(snr_db=12.04),
    "noisy": _stats(snr_db=7.5),
    "clipping": _stats(clip_fraction=0.012, min_byte=0, max_byte=255),
    "overloaded": _stats(overload_fraction=0.2),
    "dead": _stats(dead_fraction=1.0, snr_db=150.0, min_byte=127,
                   max_byte=128),
    "DC and imbalance": _stats(dc_offset_i=12.4, dc_offset_q=-6.0,
                               iq_imbalance_db=-3.4),
}


@pytest.mark.parametrize("ref,tgt", [
    ("good", "good"), ("good", "weak"), ("weak", "good"), ("usable", "noisy"),
    ("clipping", "dead"), ("overloaded", "usable"),
    ("DC and imbalance", "good"), ("dead", "DC and imbalance"),
])
def test_text_functions_give_the_same_strings(ref, tgt):
    """The verdict, recommendations, comparison and CSV line of the same
    metrics, word for word."""
    at = tqa.SignalAnalysis(ref=tqa.BlockStats(**STATS[ref]),
                            tgt=tqa.BlockStats(**STATS[tgt]))
    aj = jqa.SignalAnalysis(ref=jqa.BlockStats(**STATS[ref]),
                            tgt=jqa.BlockStats(**STATS[tgt]))
    assert tq.assess_tdoa_suitability(at) == jq.assess_tdoa_suitability(aj)
    assert tq.generate_recommendations(at) == jq.generate_recommendations(aj)
    assert tq.compare_signals(at) == jq.compare_signals(aj)
    assert tqa.fast_csv_line(at) == jqa.fast_csv_line(aj)
    assert at.suitable == aj.suitable


class _FadingBackend:
    """A custom capture backend (the protocol, not the simulator): a
    receiver whose signal never reaches the band (SNR rises 0.5 dB a dB
    of gain from −10 dB and clips above 40 dB), so the search runs out
    and reports its best clean attempt."""

    def capture(self, freq_hz, gain_db, n_samples):
        rng = np.random.default_rng(int(gain_db * 100))
        t = np.arange(n_samples)
        amp = 0.05 * 10 ** ((0.5 * gain_db - 10.0) / 20.0)
        if gain_db > 40.0:
            amp = 2.0
        x = amp * np.exp(2j * np.pi * 0.05 * t) + 0.1 * (
            rng.standard_normal(n_samples)
            + 1j * rng.standard_normal(n_samples))
        return iq_to_bytes(x.astype(np.complex64))


BACKENDS = {
    "sim seed 0": lambda pkg: pkg.SimCaptureBackend(),
    "sim seed 5": lambda pkg: pkg.SimCaptureBackend(seed=5),
    "hot signal, overload at 30 dB": lambda pkg: pkg.SimCaptureBackend(
        signal_dbfs_at_40=0.0, overload_gain_db=30.0),
    "custom backend, never in band": lambda pkg: _FadingBackend(),
}


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_calibrate_matches(backend):
    """Both frequencies: equal gain histories, convergence and iteration
    counts, SNRs within 1e-3 dB."""
    rt = tcalib.calibrate(BACKENDS[backend](tcalib), 162_400_000.0,
                          101_900_000.0, device="cpu")
    rj = jcalib.calibrate(BACKENDS[backend](jcalib), 162_400_000.0,
                          101_900_000.0)
    for t, j in zip(rt, rj):
        assert t.freq_hz == j.freq_hz
        assert (t.converged, t.iterations, t.gain_db) == \
            (j.converged, j.iterations, j.gain_db)
        assert [g for g, _ in t.history] == [g for g, _ in j.history]
        np.testing.assert_allclose([s for _, s in t.history],
                                   [s for _, s in j.history],
                                   atol=SNR_TOL_DB)
        assert abs(t.snr_db - j.snr_db) < SNR_TOL_DB
    if backend.startswith("custom"):
        assert not any(r.converged for r in rt)
    if backend.startswith("hot"):
        assert all(r.gain_db < 30.0 for r in rt)


@pytest.mark.parametrize("entry", [
    "analyze_block_bytes", "analyze_capture", "validate_dat_structure",
    "calibrate_frequency", "calibrate",
])
def test_no_card_means_an_error_unless_cpu_is_asked(monkeypatch, files,
                                                    entry):
    """The slice's device entry points run on the card by default: with no
    CUDA device visible they raise, naming device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = BYTE_CASES["good tone"]()
    calls = {
        "analyze_block_bytes": lambda **kw: tq.analyze_block_bytes(raw, **kw),
        "analyze_capture": lambda **kw: tq.analyze_capture(files["good"],
                                                           **kw),
        "validate_dat_structure": lambda **kw: tq.validate_dat_structure(
            files["good"], **kw),
        "calibrate_frequency": lambda **kw: tcalib.calibrate_frequency(
            tcalib.SimCaptureBackend(), 162.4e6, **kw),
        "calibrate": lambda **kw: tcalib.calibrate(
            tcalib.SimCaptureBackend(), 162.4e6, 101.9e6, **kw),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    assert calls[entry](device="cpu") is not None


@pytest.mark.cuda
def test_cuda_quality_pass_matches_cpu(cuda_sm90, tmp_path):
    """The card's pass against the CPU's on the same bytes: equal byte
    fractions, min/max and flags; DC within 1e-3 bytes; power within
    1e-5 relative; SNR within 1e-2 dB."""
    path = _write(tmp_path / "kx0u-1.dat", _blocks((0.3, 1.2, 0.3), 9,
                                                   n=1 << 20))
    a = tq.analyze_capture(path, device=cuda_sm90)
    b = tq.analyze_capture(path, device="cpu")
    ra = tq.validate_dat_structure(path, device=cuda_sm90)
    rb = tq.validate_dat_structure(path, device="cpu")
    assert ra.problems == rb.problems
    for sa, sb in [(a.ref, b.ref), (a.tgt, b.tgt),
                   *zip(ra.block_stats, rb.block_stats)]:
        for f in FRACTIONS + ("min_byte", "max_byte") + FLAGS:
            assert getattr(sa, f) == getattr(sb, f), f
        assert abs(sa.dc_offset_i - sb.dc_offset_i) < 1e-3
        assert abs(sa.dc_offset_q - sb.dc_offset_q) < 1e-3
        assert abs(sa.power - sb.power) <= 1e-5 * sb.power
        assert abs(sa.snr_db - sb.snr_db) < 1e-2
