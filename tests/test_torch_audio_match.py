"""Audio-pattern matching of the port (``tdoa_tpu_torch/pipeline/
audio_match.py``, ``io/wav.py``, ``cli/audio_match.py``) against
``tdoa_tpu`` on the same inputs, CPU tensors on the port's side.

The port demodulates on the reference's TPU route on every device (one
kernel-3 call over the stations and the template, then each channel's
mean removed), so the audio domain is held to the reference with its
Pallas demod kernel in interpret mode (``on_tpu`` patched, as
``tests/test_torch_streaming.py`` does): TOA within 1.6e-2 IQ samples
(2e-3 audio samples at D = 8, the FM-mode bound of
``tests/test_torch_pipeline_fm.py``; the TPU kernel's polynomial atan2
against ``atan2f``), σ within 5 %, quality within 1e-3 relative. The
rf domain runs the CAF in both packages: TOA within 2e-3 samples, LO
within 1e-2 Hz, quality within 1e-4 relative (the CAF's bounds in
``tests/test_torch_caf.py``). ``match_captures`` is held to the bounds
of ``tests/test_audio_match.py`` on its healthy and FM-threshold scenes
(the JAX simulator's, at its 2^17-sample blocks) and to the reference
run on the same captures within the bounds above (the pairwise pass on
the same segmented geometry, ``accumulator="xla"``, so the clock terms
agree too). Measured on these inputs: audio and rf TOAs within 2e-5
samples of the reference's, LO offsets within 1e-4 Hz, the pairwise
clock terms equal.
"""

import contextlib
import io
import json
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90, fix_error_m, scene  # noqa: F401

try:  # the card's machine has no JAX: there only the `cuda` tests run
    import jax
    import jax.numpy as jnp
    from tdoa_tpu.dsp.filters import resample_fft as jresample
    from tdoa_tpu.dsp.fm import fm_modulate as jmodulate
    from tdoa_tpu.ops.cplx import from_complex, to_complex
    from tdoa_tpu.ops.pallas import fm_demod as jfm
    from tdoa_tpu.pipeline import TDOAProcessor as JaxProcessor
    from tdoa_tpu.pipeline import audio_match as jam
    from tdoa_tpu.sim import NoiseProfile, simulate_scene, write_scene_captures
    from tdoa_tpu.sim.delay import fractional_delay as jdelay
    from tdoa_tpu.sim.source import bandlimited_noise as jnoise
    from tdoa_tpu.utils import platform as jplatform
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.io.wav import read_wav, write_wav
from tdoa_tpu_torch.pipeline import TDOAProcessor
from tdoa_tpu_torch.pipeline import audio_match as tam
from tdoa_tpu_torch.pipeline.processor import HostCapture

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
    "tgt_tx_lla": np.array([41.30888549464701, -96.02619229605524, 356.0]),
    "ref_freq": 162_400_000.0,
    "tgt_freq": 101_900_000.0,
}
FREQS = (OMAHA["ref_freq"], OMAHA["tgt_freq"])
FS = 2_000_000.0
BLOCK = 1 << 17
CPU = torch.device("cpu")
AUDIO_TOL = dict(toa=1.6e-2, std=0.05, quality=1e-3)
RF_TOL = dict(toa=2e-3, lo=1e-2, quality=1e-4)


@contextlib.contextmanager
def tpu_demod_branch():
    """The reference's ``match_template_audio`` on its TPU route (the
    Pallas demod kernel per channel, in interpret mode): its route is
    decided when it is traced, so the caches are cleared around it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jplatform, "on_tpu", lambda: True)
        mp.setattr(jfm, "default_interpret_mode", lambda: True)
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


def jax_audio_tpu(*args, fn=None, **kw):
    """The reference's audio domain on its TPU route (``fn``: the
    reference function itself, where its module name is patched)."""
    with tpu_demod_branch():
        return jax.block_until_ready(
            (fn or jam.match_template_audio)(*args, **kw))


def _planar(c):
    """Reference planar ``C`` → port planar f32 tensor ``[2, ...]``."""
    return torch.from_numpy(np.stack([np.asarray(c.re), np.asarray(c.im)])
                            .astype(np.float32))


def _close(got, want, atol=0.0, rtol=0.0):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), atol=atol,
                               rtol=rtol)


# ---- the four matched-filter cases of tests/test_audio_match.py ------

def _delayed_stations(tpl, delays, noise=0.02, lo_hz=None, seed=3):
    """tests/test_audio_match.py's stations: the template delayed per
    station, optional LO offsets, complex noise (numpy)."""
    rng = np.random.default_rng(seed)
    z = to_complex(tpl)
    chans = []
    for k, d in enumerate(delays):
        rx = jdelay(z, jnp.float32(d))
        if lo_hz is not None:
            t = jnp.arange(z.shape[-1]) / FS
            rx = rx * jnp.exp(2j * jnp.pi * lo_hz[k] * t)
        rx = np.asarray(rx) + noise * (
            rng.standard_normal(z.shape[-1])
            + 1j * rng.standard_normal(z.shape[-1]))
        chans.append(rx.astype(np.complex64))
    return from_complex(jnp.asarray(np.stack(chans)))


FILTER_CASES = {
    # name: (noise key, delays, LO offsets, domain)
    "audio_known_delays": (4, [0.0, 36.5, -20.25], None, "audio"),
    "audio_survives_lo_offsets": (5, [5.0, -12.5, 30.0],
                                  np.array([80.0, -150.0, 40.0]), "audio"),
    "rf_recovers_delay_and_lo": (6, [3.25, -41.0, 17.5],
                                 np.array([12.0, -85.0, 150.0]), "rf"),
}


@pytest.fixture(scope="module")
def filter_cases():
    out = {}
    for name, (key, delays, lo, domain) in FILTER_CASES.items():
        audio = jnoise(jax.random.PRNGKey(key), BLOCK, 15e3, FS)
        tpl = jmodulate(audio, FS, deviation_hz=50e3)
        tgt = _delayed_stations(tpl, delays, lo_hz=lo)
        if domain == "audio":
            want = jax_audio_tpu(tgt, tpl, sample_rate=FS, decim=8,
                                 max_lag=512)
        else:
            want = jam.match_template_rf(tgt, tpl, sample_rate=FS,
                                         max_lag=512, lo_span_hz=200.0,
                                         n_doppler=64)
        out[name] = (_planar(tgt), _planar(tpl), want)
    return out


@pytest.mark.parametrize("name", list(FILTER_CASES))
def test_matched_filter_matches_the_reference(filter_cases, name):
    _, delays, lo, domain = FILTER_CASES[name]
    tgt, tpl, want = filter_cases[name]
    if domain == "audio":
        m = tam.match_template_audio(tgt, tpl, sample_rate=FS, decim=8,
                                     max_lag=512)
        _close(m.toa_samples, want.toa_samples, atol=AUDIO_TOL["toa"])
        _close(m.toa_std, want.toa_std, rtol=AUDIO_TOL["std"])
        _close(m.quality, want.quality, rtol=AUDIO_TOL["quality"])
        assert m.lo_offset_hz is None
        # the reference test's bounds
        toa = m.toa_samples.numpy()
        np.testing.assert_allclose(toa, delays, atol=2.0)
        if lo is None:
            assert abs((toa[1] - toa[0]) - (delays[1] - delays[0])) < 1.0
            assert m.quality.min() > 5.0
    else:
        m = tam.match_template_rf(tgt, tpl, sample_rate=FS, max_lag=512,
                                  lo_span_hz=200.0, n_doppler=64)
        _close(m.toa_samples, want.toa_samples, atol=RF_TOL["toa"])
        _close(m.lo_offset_hz, want.lo_offset_hz, atol=RF_TOL["lo"])
        _close(m.quality, want.quality, rtol=RF_TOL["quality"])
        _close(m.toa_std, want.toa_std, rtol=RF_TOL["quality"])
        assert m.lo_span_eff_hz == want.lo_span_eff_hz
        np.testing.assert_allclose(m.toa_samples.numpy(), delays, atol=0.5)
        np.testing.assert_allclose(m.lo_offset_hz.numpy(), lo, atol=3.0)
        assert m.quality.min() > 5.0


def test_template_iq_pads_and_reports_coverage():
    audio = np.ones(1000, np.float32) * 0.1
    tpl, covered = tam.template_iq(audio, 44100.0, 1 << 16, FS, 25e3,
                                   device=CPU)
    n_res = int(round(1000 * FS / 44100.0))
    assert tpl.shape == (2, 1 << 16) and tpl.dtype == torch.float32
    assert abs(covered - n_res / (1 << 16)) < 1e-9
    tail = (tpl[0] ** 2 + tpl[1] ** 2)[n_res + 1:]
    assert float(tail.max()) < 1e-9
    # against the reference's template: its phase is an f32 cumulative
    # sum that rounds at every step (measured 1.2e-4 apart here)
    want, cov_j = jam.template_iq(audio, 44100.0, 1 << 16, FS, 25e3)
    assert covered == cov_j
    _close(tpl, np.stack([np.asarray(want.re), np.asarray(want.im)]),
           atol=1e-3)
    # a longer recording truncates to the window and covers all of it
    long_tpl, cov = tam.template_iq(np.ones(44100, np.float32) * 0.1,
                                    44100.0, 1 << 16, FS, device=CPU)
    assert cov == 1.0 and long_tpl.shape == (2, 1 << 16)


def test_template_iq_at_full_width_against_float64():
    """A 10 s recording at 44.1 kHz on the 20,000,000-sample capture
    clock, deviation 50 kHz: the template's phase (resampled and
    integrated in float32 on the CPU; it reaches 824 rad) against
    float64 numpy. Measured: at most 2.9e-4 rad over the 20 M samples;
    bound 2e-3 rad."""
    rng = np.random.default_rng(8)
    n44 = 441_000
    spec = np.fft.rfft(rng.standard_normal(n44))
    spec[np.fft.rfftfreq(n44, 1 / 44100.0) > 10e3] = 0
    audio = np.fft.irfft(spec, n44)
    audio = (0.8 * audio / np.abs(audio).max()).astype(np.float32)
    n = 20_000_000
    tpl, covered = tam.template_iq(audio, 44100.0, n, FS, 50e3, device=CPU)
    assert covered == 1.0 and tpl.shape == (2, n)
    # float64: the same Fourier resampling, then the phase integral
    k_in, k_out = n44 // 2 + 1, n // 2 + 1
    s = np.zeros(k_out, np.complex128)
    s[:k_in] = np.fft.rfft(audio.astype(np.float64))
    s[k_in - 1] *= 0.5  # even input: its Nyquist bin splits in two
    a = np.fft.irfft(s, n) * (n / n44)
    del s
    phase = (2 * np.pi * 50e3 / FS) * np.cumsum(a)
    del a
    err = torch.atan2(tpl[1], tpl[0]).numpy() - phase
    err = np.abs(np.remainder(err + np.pi, 2 * np.pi) - np.pi)
    assert err.max() < 2e-3, err.max()
    np.testing.assert_allclose((tpl ** 2).sum(0).numpy(), 1.0, atol=1e-5)


def test_median_averages_the_two_middle_values():
    """Every audio row here has even length (L / 8); ``torch.median``
    would return the lower middle value, the reference's ``jnp.median``
    averages the two."""
    x = torch.tensor([[3.0, 1.0, 4.0, 1.5, 9.0, 2.0],
                      [0.0, -2.0, 5.0, 5.0, 1.0, 7.0]])
    got = tam._median(x)
    assert got.shape == (2, 1)
    _close(got[:, 0], np.median(x.numpy(), axis=-1), atol=0)
    _close(got, jnp.median(jnp.asarray(x.numpy()), axis=-1, keepdims=True),
           atol=0)
    assert float(got[0, 0]) == 2.5 and float(torch.median(x[0])) == 2.0
    odd = torch.tensor([[5.0, 1.0, 3.0]])
    assert float(tam._median(odd)) == 3.0
    # a long even row, as the audio domain's
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 1 << 14)).astype(np.float32))
    _close(tam._median(r)[:, 0], np.median(r.numpy(), axis=-1), atol=1e-7)


def test_decim_must_divide_128(filter_cases):
    """The port demodulates on kernel 3 on every device, so a decimation
    that does not divide the kernel's 128 taps is refused (the
    reference's CPU route would take it)."""
    tgt, tpl, _ = filter_cases["audio_known_delays"]
    with pytest.raises(ValueError, match="divide"):
        tam.match_template_audio(tgt, tpl, sample_rate=FS, decim=6,
                                 max_lag=512)


# ---- cross-validation gates (copies: exact) --------------------------

def _fake_fix(lat, lon, semi_major):
    from tdoa_tpu_torch.solve.multilateration import FixResult

    return FixResult(
        lat=lat, lon=lon, elev=300.0, enu=np.zeros(3),
        rms_residual_m=1.0, origin_lla=np.array([lat, lon, 300.0]),
        ellipse=(semi_major, semi_major / 2, 0.0),
    )


def _fake_pairwise(tdoa_samples, std_samples, fix):
    class PW:
        corrected_tdoa_samples = np.asarray(tdoa_samples, np.float64)
        tdoa_std_s = np.asarray(std_samples, np.float64) / FS
    PW.fix = fix
    return PW


VALIDATION = {
    # the Monte Carlo silent failure (seed 21908): both rungs must fire
    "seed_21908": ([-12.029, 52.831, 64.859], [-15.869, 39.392, 55.266],
                   [2.02, 3.72, 3.26], (41.28, -95.98, 300.0),
                   (41.262, -95.98, 120.0), 2),
    # sub-sample disagreement, fixes ~11 m apart: quiet
    "agreement": ([-15.5, 39.8, 55.4], [-15.9, 39.4, 55.3],
                  [0.05] * 3, (41.2621, -95.98, 80.0),
                  (41.2620, -95.98, 80.0), 0),
}


@pytest.mark.parametrize("name", list(VALIDATION))
def test_cross_validation_gates(name):
    corrected, pw_tdoa, sigma, ft, fp, n_warn = VALIDATION[name]
    names = ("st0", "st1", "st2")
    pairs = np.array([[0, 1], [0, 2], [1, 2]])
    pw = _fake_pairwise(pw_tdoa, np.full(3, 0.05), _fake_fix(*fp))
    args = (np.array(corrected), np.array(sigma), pw, _fake_fix(*ft), names,
            pairs, FS)
    warns = tam.cross_validation_warnings(*args)
    assert len(warns) == n_warn
    if n_warn:
        assert "disagree" in warns[0]
        assert "fix" in warns[1] and "apart" in warns[1]
    assert tam._cross_validation(*args) == jam._cross_validation(*args)


# ---- match_captures on the reference tests' scenes -------------------

def _known_audio_scene(seed=7, **kw):
    """tests/test_audio_match.py's scene whose TGT emitter broadcasts a
    KNOWN 44.1 kHz recording (10 kHz band-limited noise, peak 0.8,
    deviation 50 kHz)."""
    n44 = int(round(BLOCK * 44100.0 / FS))
    audio44 = np.asarray(jnoise(jax.random.PRNGKey(seed), n44, 10e3,
                                44100.0))
    audio44 = 0.8 * audio44 / np.abs(audio44).max()
    n_res = int(round(n44 * FS / 44100.0))
    audio_fs = np.asarray(jresample(jnp.asarray(audio44), n_res))
    sc = scene(OMAHA, BLOCK, seed, tgt_audio=audio_fs,
               tgt_deviation_hz=50e3,
               clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]), **kw)
    return sc, audio44


SCENES = {
    "healthy": {},
    "fm_threshold": {"tgt_profile": "threshold"},
}
MODES = ("audio", "rf", "auto")


def _tgt_errors(res, truth):
    """max |corrected − truth| over the pairs, in the result's order."""
    by = {n: k for k, n in enumerate(OMAHA["names"])}
    tau = truth.station_delays_samples[:, 1]
    order = [by[n] for n in res.station_names]
    want = np.array([tau[order[j]] - tau[order[i]] for i, j in res.pair_idx])
    return np.abs(np.asarray(res.corrected_tdoa_samples) - want).max()


@pytest.fixture(scope="module")
def matched(tmp_path_factory):
    """Per scene: the captures, the truth, the recording, and both
    packages' match_captures in every mode (the reference's audio domain
    on its TPU route)."""
    out = {}
    for name, kw in SCENES.items():
        if kw.get("tgt_profile") == "threshold":
            kw = {"tgt_profile": NoiseProfile(signal_amplitude=1.0,
                                              noise_amplitude=0.6)}
        sc, audio44 = _known_audio_scene(**kw)
        caps, truth = simulate_scene(sc)
        caps = {n: tuple(np.asarray(b) for b in caps[n])
                for n in sc.station_names}
        jp = JaxProcessor.from_csv(*FREQS, CSV, seg_len=None, max_lag=1024)
        tp = TDOAProcessor.from_csv(*FREQS, CSV, device=CPU, seg_len=None,
                                    max_lag=1024, accumulator="xla")
        res = {}
        with pytest.MonkeyPatch.context() as mp:
            # The reference's pairwise pass and audio domain are the same
            # in every mode: each runs once and is handed out again.
            ref_mta, ref_pc, memo = jam.match_template_audio, \
                jp.process_captures, {}

            def audio_tpu(*a, **k):
                if "audio" not in memo:
                    memo["audio"] = jax_audio_tpu(*a, fn=ref_mta, **k)
                return memo["audio"]

            def pairwise(c):
                if "pairwise" not in memo:
                    memo["pairwise"] = ref_pc(c)
                return memo["pairwise"]

            mp.setattr(jam, "match_template_audio", audio_tpu)
            mp.setattr(jp, "process_captures", pairwise)
            for mode in MODES:
                res[("jax", mode)] = jam.match_captures(
                    jp, caps, audio44, 44100.0, mode=mode,
                    deviation_hz=50e3)
        for mode in MODES:
            res[("port", mode)] = tam.match_captures(
                tp, caps, audio44, 44100.0, mode=mode, deviation_hz=50e3)
        out[name] = {"scene": sc, "truth": truth, "caps": caps,
                     "audio44": audio44, "res": res}
    return out


@pytest.mark.parametrize("scene_name", list(SCENES))
@pytest.mark.parametrize("mode", MODES)
def test_match_captures_matches_the_reference(matched, scene_name, mode):
    r = matched[scene_name]["res"]
    got, want = r[("port", mode)], r[("jax", mode)]
    assert got.mode_used == want.mode_used
    assert got.station_names == want.station_names
    tol = AUDIO_TOL if got.mode_used == "audio" else RF_TOL
    np.testing.assert_allclose(got.toa_samples, want.toa_samples,
                               atol=tol["toa"])
    np.testing.assert_allclose(got.station_quality, want.station_quality,
                               rtol=tol["quality"])
    np.testing.assert_allclose(got.toa_std_samples, want.toa_std_samples,
                               rtol=AUDIO_TOL["std"])
    # the pairwise clock terms (same segmented geometry) ride along
    np.testing.assert_allclose(got.pairwise.clock_offset_samples,
                               want.pairwise.clock_offset_samples,
                               atol=2e-3)
    np.testing.assert_allclose(got.corrected_tdoa_samples,
                               want.corrected_tdoa_samples,
                               atol=tol["toa"] + 2e-3)
    assert (got.lo_offset_hz is None) == (want.lo_offset_hz is None)
    if got.lo_offset_hz is not None:
        np.testing.assert_allclose(got.lo_offset_hz, want.lo_offset_hz,
                                   atol=RF_TOL["lo"])
    assert len(got.warnings) == len(want.warnings)
    assert got.covered_fraction == want.covered_fraction


@pytest.mark.parametrize("mode", MODES)
def test_healthy_scene_within_the_reference_bounds(matched, mode):
    """tests/test_audio_match.py::test_audio_match_e2e's bounds in every
    mode; auto keeps the audio result without escalating."""
    m = matched["healthy"]
    res = m["res"][("port", mode)]
    assert _tgt_errors(res, m["truth"]) < 4.0
    np.testing.assert_allclose(res.corrected_tdoa_samples,
                               res.pairwise.corrected_tdoa_samples, atol=4.0)
    assert res.covered_fraction > 0.99
    if mode != "rf":
        assert fix_error_m(res.fix, m["scene"].tgt_tx_lla) < 4000.0
        assert res.mode_used == "audio" and res.lo_offset_hz is None
        assert not any("escalated" in w for w in res.warnings)
    else:
        assert res.lo_offset_hz is not None
        assert np.abs(res.lo_offset_hz).max() < 3.0  # no LO offsets planted


def test_fm_threshold_scene_escalates_to_rf(matched):
    """tests/test_audio_match.py::
    test_audio_match_auto_escalates_under_fm_threshold_noise: the audio
    domain collapses, auto escalates to the rf domain, keeps its result
    and names the escalation."""
    m = matched["fm_threshold"]
    res_audio, res_auto = (m["res"][("port", k)] for k in ("audio", "auto"))
    assert _tgt_errors(res_audio, m["truth"]) > 4.0
    assert res_auto.mode_used == "rf"
    assert any("escalated" in w for w in res_auto.warnings)
    assert _tgt_errors(res_auto, m["truth"]) < 4.0
    assert res_auto.lo_offset_hz is not None


def test_bf16_blocks_match_f32_blocks(tmp_path):
    """The captures ``load_files`` decodes on the fused path are bf16
    (blocks of 8 kernel segments or more; shorter ones take the
    segmented route in f32); ``match_captures`` casts them to f32 as the
    reference's ``prep`` does. The same u8 files decoded to bf16 and to
    f32, through the fused pairwise path (kernel 1's plain version) and
    both domains: pairwise results equal (the fused path rounds its
    operands to bf16 either way), template TOAs within 1e-3 samples and
    PSRs within 1e-3 relative — the bf16 rounding of the TGT samples
    (measured: 8.4e-5 samples audio, 3.1e-5 rf; PSR 1e-5 relative)."""
    from tdoa_tpu_torch.io.datfile import load_dat, save_dat

    sc, audio44 = _known_audio_scene(
        seed=9, tgt_profile=NoiseProfile(signal_amplitude=1.0,
                                         noise_amplitude=0.05))
    paths, _ = write_scene_captures(sc, str(tmp_path))
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device=CPU, seg_len=None,
                                max_lag=1024, accumulator="pallas")
    caps = {}
    for dtype in (torch.bfloat16, torch.float32):
        caps[dtype] = {}
        for n in sc.station_names:
            c = load_dat(paths[n], dtype=dtype, device=CPU)
            caps[dtype][n] = (c.ref1, c.tgt, c.ref2)
    long_dir = tmp_path / "long"
    long_dir.mkdir()
    block = np.zeros(8 * 45056, np.complex64)
    long_paths = [str(long_dir / f"{n}-1700000000.dat")
                  for n in sc.station_names]
    for p in long_paths:
        save_dat(p, block, block, block)
    for proc, files, dtype in ((tp, sorted(paths.values()), torch.float32),
                               (tp, long_paths, torch.bfloat16)):
        assert proc.load_files(files)["kx0u"][1].dtype == dtype
    for mode in ("audio", "rf"):
        r16, r32 = (tam.match_captures(tp, caps[d], audio44, 44100.0,
                                       mode=mode, deviation_hz=50e3)
                    for d in (torch.bfloat16, torch.float32))
        np.testing.assert_array_equal(r16.pairwise.corrected_tdoa_samples,
                                      r32.pairwise.corrected_tdoa_samples)
        np.testing.assert_allclose(r16.toa_samples, r32.toa_samples,
                                   atol=1e-3)
        np.testing.assert_allclose(r16.station_quality, r32.station_quality,
                                   rtol=1e-3)


def test_match_captures_rejects_unknown_mode_and_host_captures():
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device=CPU, seg_len=None,
                                max_lag=1024)
    with pytest.raises(ValueError, match="mode must be"):
        tam.match_captures(tp, {}, np.zeros(10), 44100.0, mode="banana")
    hc = HostCapture(u16=np.zeros(3 << 12, np.uint16), block_len=1 << 12)
    with pytest.raises(ValueError, match="HostCapture"):
        tam.match_captures(tp, {n: hc for n in OMAHA["names"]},
                           np.zeros(10), 44100.0, mode="audio")


def test_match_captures_times_its_stages(matched):
    class Timer:
        def __init__(self):
            self.names = []

        @contextlib.contextmanager
        def stage(self, name):
            self.names.append(name)
            yield

    m = matched["healthy"]
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device=CPU, seg_len=None,
                                max_lag=1024, accumulator="xla")
    tp.timer = Timer()
    tam.match_captures(tp, m["caps"], m["audio44"], 44100.0, mode="auto",
                       deviation_hz=50e3)
    for name in ("pairwise", "template", "audio domain", "rf domain",
                 "assemble/solve"):
        assert name in tp.timer.names


# ---- WAV codec and the CLI ------------------------------------------

def test_wav_codec_equals_the_reference(tmp_path):
    from tdoa_tpu.io.wav import read_wav as jread

    rng = np.random.default_rng(0)
    audio = np.clip(rng.standard_normal(4410) * 0.3, -1, 1).astype(np.float32)
    path = str(tmp_path / "a.wav")
    write_wav(path, 44100, audio)
    fs, back = read_wav(path)
    assert fs == 44100.0
    np.testing.assert_allclose(back, audio, atol=2.0 / 32768)
    assert np.array_equal(back, jread(path)[1])
    # 8-bit, 24-bit and stereo files decode as the reference decodes them
    for width, ch, raw in ((1, 1, np.array([128, 255, 0, 192], np.uint8)
                            .tobytes()),
                           (3, 1, b"".join(int(v & 0xFFFFFF).to_bytes(
                               3, "little") for v in (1 << 22, -(1 << 22), 0))),
                           (2, 2, np.round(np.array([0.5, -0.25] * 50)
                                           * 32767).astype("<i2").tobytes())):
        p = str(tmp_path / f"w{width}{ch}.wav")
        with wave.open(p, "wb") as w:
            w.setnchannels(ch)
            w.setsampwidth(width)
            w.setframerate(8000)
            w.writeframes(raw)
        assert np.array_equal(read_wav(p)[1], jread(p)[1])


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """tests/test_audio_match.py::test_audio_match_cli_json's scene: seed
    9, default profiles, as .dat files, and its recording as a WAV."""
    root = tmp_path_factory.mktemp("audio-cli")
    sc, audio44 = _known_audio_scene(seed=9)
    paths, truth = write_scene_captures(sc, str(root))
    wav = str(root / "rec.wav")
    write_wav(wav, 44100, audio44)
    return sc, sorted(paths.values()), wav, truth


def test_cli_json_matches_match_captures(cli_files, capsys):
    from tdoa_tpu_torch.cli.audio_match import main

    sc, files, wav, truth = cli_files
    argv = [*map(str, FREQS), CSV, wav, *files, "--seg-len", str(BLOCK),
            "--max-lag", "1024", "--json", "--deviation", "50000",
            "--match-mode", "audio"]
    assert main([*argv, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device=CPU, seg_len=BLOCK,
                                max_lag=1024)
    fs_w, audio = read_wav(wav)
    res = tam.match_captures(tp, tp.load_files(files), audio, fs_w,
                             mode="audio", deviation_hz=50e3)
    assert out["stations"] == res.station_names
    np.testing.assert_allclose(out["tdoa_us"], res.tdoa_seconds * 1e6,
                               atol=1e-6)
    assert out["fix"]["lat"] == res.fix.lat and out["mode_used"] == "audio"
    # the reference test's bounds
    got = np.array(out["tdoa_us"])
    want = truth.tgt_tdoa_samples / FS * 1e6
    assert np.abs(np.sort(np.abs(got)) - np.sort(np.abs(want))).max() < 3.0
    assert out["fix"]["lat"] == pytest.approx(sc.tgt_tx_lla[0], abs=0.05)
    assert out["covered_fraction"] > 0.99
    # the same keys as the reference CLI's JSON
    from tdoa_tpu.cli.audio_match import main as jmain

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jmain(argv) == 0
    assert set(json.loads(buf.getvalue())) == set(out)


def test_cli_text_output_and_errors(cli_files, capsys, tmp_path):
    from tdoa_tpu_torch.cli.audio_match import main

    _, files, wav, _ = cli_files
    argv = [*map(str, FREQS), CSV, wav, *files, "--max-lag", "1024",
            "--deviation", "50000", "--match-mode", "rf", "--device", "cpu"]
    assert main(argv) == 0
    text = capsys.readouterr().out
    assert "mode=rf" in text and "LO" in text and "Template fix" in text
    missing = [*argv[:3], str(tmp_path / "none.wav"), *argv[4:]]
    assert main(missing) == 2
    assert "error" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert main(argv[:-2]) == 2
        assert "no CUDA device" in capsys.readouterr().err


# ---- on the card -----------------------------------------------------

@pytest.mark.cuda
def test_cuda_audio_domain_matches_cpu(cuda_sm90):
    """``match_template_audio`` on the card (kernel 3, one launch for the
    stations and the template) against the CPU (its plain version) on
    the same blocks: TOAs within 1e-3 samples, σ and quality within 1e-3
    relative. No JAX here."""
    from _torch_port_helpers import fm_block
    from tdoa_tpu_torch.ops.kernels.fm_demod import fm_demod_decimate

    x = fm_block(4, 1 << 18, [0.0, 0.0, 36.5, -20.25], seed=4, noise=0.05)
    tgt = torch.from_numpy(x[:, 1:])
    tpl = torch.from_numpy(x[:, 0])
    cpu = tam.match_template_audio(tgt, tpl, sample_rate=FS, decim=8,
                                   max_lag=512)
    fm_demod_decimate.launches = 0
    fm_demod_decimate.launch_shapes.clear()
    card = tam.match_template_audio(tgt.to(cuda_sm90), tpl.to(cuda_sm90),
                                    sample_rate=FS, decim=8, max_lag=512)
    assert fm_demod_decimate.launches == 1
    assert dict(fm_demod_decimate.launch_shapes) == {(4, 1 << 18, 8): 1}
    np.testing.assert_allclose(card.toa_samples.cpu().numpy(),
                               cpu.toa_samples.numpy(), atol=1e-3)
    np.testing.assert_allclose(card.toa_std.cpu().numpy(),
                               cpu.toa_std.numpy(), rtol=1e-3)
    np.testing.assert_allclose(card.quality.cpu().numpy(),
                               cpu.quality.numpy(), rtol=1e-3)
    np.testing.assert_allclose(cpu.toa_samples.numpy(), [0.0, 36.5, -20.25],
                               atol=2.0)


@pytest.mark.cuda
def test_cuda_template_is_bitwise_repeatable(cuda_sm90):
    """The template of a 10 s recording at 2 Msps (20 M samples) comes
    out the same bit for bit on every call: its FM phase integral is
    ``dsp.fm.running_sum``, not one ``torch.cumsum`` over the row, whose
    single-pass scan on the card changes its float association from run
    to run (a CLI run and an in-process run of the same match disagreed
    by one float32 ulp of a TDOA)."""
    rng = np.random.default_rng(4)
    audio = (0.5 * rng.standard_normal(441_000)).astype(np.float32)
    first = tam.template_iq(audio, 44100.0, 20_000_000, device=cuda_sm90)[0]
    for _ in range(3):
        again = tam.template_iq(audio, 44100.0, 20_000_000,
                                device=cuda_sm90)[0]
        assert torch.equal(first, again)

