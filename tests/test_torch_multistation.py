"""Networks beyond three stations: the eight cases of
``tests/test_multistation.py`` through both packages on the CPU. Each
scene is made once by the JAX simulator; its captures go through
``tdoa_tpu``'s and ``tdoa_tpu_torch``'s ``process_captures`` (the
segmented route on both sides: the blocks are 2^16 samples), the exact
TDOAs through both ``solve_fix``. The port is held to the reference
(corrected TDOAs within 2e-3 samples, σ within 5 %, the same excluded
stations, the same warnings word for word, fixes within 5 % of the
ellipse's semi-minor axis) and to each reference test's own bound on
the truth."""

import re

import numpy as np
import pytest

from _torch_port_helpers import assert_warnings_match, fix_error_m, tables

try:  # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from tdoa_tpu.pipeline.processor import HostCapture as JHostCapture
    from tdoa_tpu.pipeline.processor import ProcessorConfig as JConfig
    from tdoa_tpu.pipeline.processor import TDOAProcessor as JProcessor
    from tdoa_tpu.sim import SimScene, simulate_scene
    from tdoa_tpu.solve import solve_fix as jsolve_fix
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.geo import lla_to_ecef, lla_to_enu
from tdoa_tpu_torch.io.datfile import iq_bytes_as_u16, save_dat
from tdoa_tpu_torch.pipeline.processor import (
    HostCapture,
    ProcessorConfig,
    TDOAProcessor,
)
from tdoa_tpu_torch.solve import solve_fix, station_pairs
from tdoa_tpu_torch.utils.constants import SPEED_OF_LIGHT

FIVE_LLA = np.array([
    [41.18660274289527, -95.96064116595667, 355.69],
    [41.24669616513154, -96.08366304481238, 329.0],
    [41.32916620016985, -96.03513381562004, 373.18],
    [41.26, -95.90, 340.0],
    [41.36, -96.12, 360.0],
])
SIX_LLA = np.vstack([FIVE_LLA, [41.20, -96.16, 345.0]])
NAMES = ("kx0u", "n3pay", "kf0mtl", "st4", "st5", "st6")
REF_TX = np.array([41.25703803095629, -95.95512763589404, 349.07])
TGT_TX = np.array([41.30888549464701, -96.02619229605524, 356.0])
BLOCK = 1 << 16


def _exact_tdoas(lla, tx):
    d = np.linalg.norm(lla_to_ecef(lla) - lla_to_ecef(tx), axis=-1)
    p = station_pairs(len(lla))
    return (d[p[:, 1]] - d[p[:, 0]]) / SPEED_OF_LIGHT, p


def _scene(n, seed, clock_offsets_s=None, block_len=BLOCK):
    """The reference test's scene over the first ``n`` stations: JAX
    captures as numpy blocks (the input both packages get)."""
    kw = {} if clock_offsets_s is None else {
        "clock_offsets_s": np.asarray(clock_offsets_s)}
    sc = SimScene(station_names=NAMES[:n], station_lla=SIX_LLA[:n],
                  ref_tx_lla=REF_TX, tgt_tx_lla=TGT_TX, block_len=block_len,
                  seed=seed, **kw)
    caps, _ = simulate_scene(sc)
    return sc, {s: tuple(np.asarray(b) for b in caps[s])
                for s in sc.station_names}


def _roll_tgt(caps, name, shift):
    """The reference test's planted bias: one station's TGT block delayed
    by ``shift`` samples, its REF blocks untouched."""
    r1, tgt, r2 = caps[name]
    return {**caps, name: (r1, np.roll(tgt, shift), r2)}


def _both(sc, caps, **cfg):
    """(reference result, port result) of ``caps`` through both
    processors at the reference test's settings."""
    jt, tt = tables(sc.station_names, sc.station_lla, sc.ref_tx_lla)
    freqs = dict(ref_freq=sc.ref_freq, tgt_freq=sc.tgt_freq, max_lag=512)
    rj = JProcessor(JConfig(**freqs, **cfg), jt).process_captures(
        {n: tuple(jnp.asarray(b) for b in caps[n]) for n in caps})
    rt = TDOAProcessor(ProcessorConfig(**freqs, **cfg), tt,
                       device="cpu").process_captures(caps)
    return rj, rt


@pytest.fixture(scope="module")
def runs():
    """Every pipeline case of the reference tests, each scene simulated
    once: {case: (scene, reference result, port result)}."""
    out = {}
    sc, caps = _scene(4, 41, [5e-6, -9e-6, 14e-6, -2e-6])
    out["four stations"] = (sc, *_both(sc, caps, seg_len=None))
    sc, caps = _scene(4, 47)
    keys = jax.random.split(jax.random.PRNGKey(99), 6)
    caps["st4"] = tuple(np.asarray(
        0.1 * (jax.random.normal(keys[2 * b], (BLOCK,))
               + 1j * jax.random.normal(keys[2 * b + 1], (BLOCK,))
               ).astype(jnp.complex64)) for b in range(3))
    out["dead station"] = (sc, *_both(sc, caps, seg_len=1 << 13))
    sc, caps = _scene(5, 53, [5e-6, -9e-6, 14e-6, -2e-6, 7e-6])
    one = _roll_tgt(caps, "st4", 160)
    out["one outlier of 5"] = (sc, *_both(sc, one, seg_len=None))
    out["one outlier of 5, rejection off"] = (
        sc, *_both(sc, one, seg_len=None, outlier_rejection=False))
    two = _roll_tgt(one, "n3pay", -120)
    out["two outliers of 5"] = (sc, *_both(sc, two, seg_len=None))
    sc, caps = _scene(6, 59, [5e-6, -9e-6, 14e-6, -2e-6, 7e-6, -4e-6])
    caps = _roll_tgt(_roll_tgt(caps, "st4", 160), "n3pay", -120)
    out["two outliers of 6"] = (sc, *_both(sc, caps, seg_len=None))
    return out


CASES = ("four stations", "dead station", "one outlier of 5",
         "one outlier of 5, rejection off", "two outliers of 5",
         "two outliers of 6")


# float32 resolves the minimum of a least-squares cost to about
# sqrt(eps) of its floor: where a poisoned set leaves kilometres of rms
# residual, the two packages' float32 LM solves land metres apart.
F32_SQRT_EPS = float(np.sqrt(np.finfo(np.float32).eps))


_FAR_GHOST = re.compile(r"a second solution (\d+) m away at "
                        r"([-\d.]+),([-\d.]+) fits")


def _assert_warnings_agree(wt, wj):
    """Word for word, numbers within 1e-3 relative — except a TDOA ghost
    candidate over 1000 km away, which a poisoned set leaves on the
    hyperbolas' far-field asymptote (a direction the cost barely sees):
    its distance and position within 5 %."""
    assert len(wt) == len(wj), (wt, wj)
    for a, b in zip(wt, wj):
        ga, gb = _FAR_GHOST.search(a), _FAR_GHOST.search(b)
        if gb and float(gb.group(1)) > 1e6:
            assert ga, (a, b)
            np.testing.assert_allclose([float(v) for v in ga.groups()],
                                       [float(v) for v in gb.groups()],
                                       rtol=0.05)
            a, b = _FAR_GHOST.sub("", a), _FAR_GHOST.sub("", b)
        assert_warnings_match([a], [b])


@pytest.mark.parametrize("case", CASES)
def test_port_matches_the_reference(runs, case):
    """Corrected TDOAs within 2e-3 samples, σ within 5 %, the same pairs,
    excluded stations and warnings, and the fixes within 5 % of the
    reference fix's semi-minor axis — on the sets left inconsistent
    (two outliers of five, rejection off) within float32's resolution
    of the cost's floor, sqrt(eps) of the rms residual."""
    _, rj, rt = runs[case]
    np.testing.assert_array_equal(rt.pair_idx, rj.pair_idx)
    np.testing.assert_allclose(rt.corrected_tdoa_samples,
                               rj.corrected_tdoa_samples, atol=2e-3)
    np.testing.assert_allclose(rt.tdoa_std_s, rj.tdoa_std_s, rtol=0.05)
    assert rt.excluded_stations == rj.excluded_stations
    _assert_warnings_agree(rt.warnings, rj.warnings)
    d = lla_to_enu(np.array([rt.fix.lat, rt.fix.lon, rj.fix.elev]),
                   np.array([rj.fix.lat, rj.fix.lon, rj.fix.elev]))
    assert np.linalg.norm(d[:2]) < max(
        0.05 * rj.fix.ellipse[1], F32_SQRT_EPS * rj.fix.rms_residual_m)


def test_four_station_pipeline_end_to_end(runs):
    """All six pairs, within 0.5 sample of the truth; fix within 150 m."""
    sc, _, rt = runs["four stations"]
    truth = _exact_tdoas(sc.station_lla, sc.tgt_tx_lla)[0] * sc.sample_rate
    assert len(rt.pair_idx) == 6
    np.testing.assert_allclose(rt.corrected_tdoa_samples, truth, atol=0.5)
    assert fix_error_m(rt.fix, sc.tgt_tx_lla) < 150.0


def test_broken_station_detected_and_survived(runs):
    """A dead antenna's pairs are flagged weak and rank below every
    healthy pair; the fix still lands within 500 m."""
    sc, _, rt = runs["dead station"]
    assert any("weak correlation" in w for w in rt.warnings)
    dead = [k for k, (i, j) in enumerate(rt.pair_idx)
            if "st4" in (rt.station_names[i], rt.station_names[j])]
    healthy = [k for k in range(len(rt.pair_idx)) if k not in dead]
    assert max(rt.quality[k] for k in dead) < min(
        rt.quality[k] for k in healthy)
    assert fix_error_m(rt.fix, sc.tgt_tx_lla) < 500.0


def test_outlier_station_excluded_five_stations(runs):
    """The one planted outlier is excluded and the fix recovers the
    transmitter within 150 m; with rejection off nothing is excluded and
    the set is flagged inconsistent."""
    sc, _, rt = runs["one outlier of 5"]
    assert rt.excluded_stations == ["st4"], rt.warnings
    assert any("excluded as outlier" in w for w in rt.warnings)
    assert fix_error_m(rt.fix, sc.tgt_tx_lla) < 150.0
    _, _, off = runs["one outlier of 5, rejection off"]
    assert off.excluded_stations is None
    assert any("internally inconsistent" in w for w in off.warnings)


def test_two_outliers_excluded_six_stations(runs):
    """Six stations: the pair-exclusion round finds both outliers."""
    sc, _, rt = runs["two outliers of 6"]
    assert sorted(rt.excluded_stations or []) == ["n3pay", "st4"], \
        rt.warnings
    assert fix_error_m(rt.fix, sc.tgt_tx_lla) < 150.0


def test_two_outlier_stations_inconclusive(runs):
    """Two outliers of five: no exclusion is adopted, the test says it is
    inconclusive and the set inconsistent."""
    _, _, rt = runs["two outliers of 5"]
    assert rt.excluded_stations is None
    assert any("leave-one-station-out test is inconclusive" in w
               for w in rt.warnings), rt.warnings
    assert any("internally inconsistent" in w for w in rt.warnings)


def _solve_both(lla, tdoas, **kw):
    return jsolve_fix(lla, tdoas, **kw), solve_fix(lla, tdoas, **kw)


def _assert_fixes_agree(ft, fj):
    """Exact TDOAs and no error bars give no ellipse: within 0.5 m, the
    solver tests' bound (tests/test_torch_solve.py), and the same
    candidates."""
    d = lla_to_enu(np.array([ft.lat, ft.lon, fj.elev]),
                   np.array([fj.lat, fj.lon, fj.elev]))
    assert np.linalg.norm(d[:2]) < 0.5
    assert len(ft.candidates_lla) == len(fj.candidates_lla)


@pytest.mark.parametrize("case", ["2D, all 10 pairs", "3D, airborne",
                                  "one bad pair at zero weight"])
def test_solves_match_the_reference(case):
    """The three solver cases: five stations' exact TDOAs (all pairs;
    an airborne transmitter with ``solve_z``; one TDOA 30 µs wrong at
    zero weight) through both solvers, each within the reference test's
    bound of the truth."""
    if case == "2D, all 10 pairs":
        tx = np.array([41.28, -96.01, 350.0])
        tdoas, p = _exact_tdoas(FIVE_LLA, tx)
        assert len(p) == 10
        fj, ft = _solve_both(FIVE_LLA, tdoas)
        bound = 5.0
    elif case == "3D, airborne":
        tx = np.array([41.28, -96.01, 1850.0])
        tdoas, _ = _exact_tdoas(FIVE_LLA, tx)
        fj, ft = _solve_both(FIVE_LLA, tdoas, solve_z=True)
        bound = 50.0
        assert ft.elev > 600.0
    else:
        tx = np.array([41.30, -96.04, 352.0])
        tdoas, p = _exact_tdoas(FIVE_LLA, tx)
        tdoas[3] += 30e-6
        w = np.ones(len(p))
        w[3] = 0.0
        fj, ft = _solve_both(FIVE_LLA, tdoas, weights=w)
        bound = 10.0
    _assert_fixes_agree(ft, fj)
    assert fix_error_m(ft, tx) < bound



# The tail session's geometry: the segmented correlator on both sides
# (tests/test_torch_ingest.py's), a block of 2^17 samples in chunks of a
# quarter block.
TAIL_BLOCK = 1 << 17
TAIL_CFG = dict(seg_len=1 << 14, max_lag=512)


def _tail(proc, names, views, capture_cls):
    """A tail session of ``proc`` fed the files in ten growth steps (views
    cut to k/10), then ``process_captures(caps, tail=session)``: (result,
    session, chunks dispatched before the last step)."""
    sess = proc.tail_session(names, TAIL_BLOCK,
                             chunk_samples=TAIL_BLOCK // 4)
    total, before = views[0].shape[0], 0
    for k in range(1, 11):
        d = sess.feed([v[:total * k // 10] for v in views])
        if k < 10:
            before += d
    caps = {n: capture_cls(u16=v, block_len=TAIL_BLOCK)
            for n, v in zip(sess.names, views)}
    return proc.process_captures(caps, tail=sess), sess, before


def test_tail_session_at_five_stations_matches_jax(tmp_path):
    """A 5-station capture with st4's TGT 160 samples late, written as
    ``.dat`` files and followed by a tail session in ten growth steps on
    both packages: all but the last chunks went out before the last
    step; corrected TDOAs within 0.05 sample (the bound between the
    reference's own paths), st4 alone excluded on both sides, the same
    warnings and ghost verdict; the clean pairs within 0.5 sample of the
    truth."""
    sc, caps = _scene(5, 53, [5e-6, -9e-6, 14e-6, -2e-6, 7e-6],
                      block_len=TAIL_BLOCK)
    caps = _roll_tgt(caps, "st4", 160)
    names = sorted(sc.station_names)
    views = []
    for n in names:
        path = tmp_path / f"{n}.dat"
        save_dat(str(path), *caps[n])
        raw = np.memmap(path, dtype=np.uint8, mode="r")
        views.append(iq_bytes_as_u16(raw))
    jt, tt = tables(sc.station_names, sc.station_lla, sc.ref_tx_lla)
    freqs = dict(ref_freq=sc.ref_freq, tgt_freq=sc.tgt_freq)
    rj, _, _ = _tail(JProcessor(JConfig(**freqs, **TAIL_CFG), jt), names,
                     views, JHostCapture)
    rt, sess, before = _tail(
        TDOAProcessor(ProcessorConfig(**freqs, accumulator="xla",
                                      **TAIL_CFG), tt, device="cpu"),
        names, views, HostCapture)
    assert sess.names == names and sess.total_chunks == 12
    assert before >= sess.total_chunks - 2
    assert rt.station_names == rj.station_names == names
    np.testing.assert_array_equal(rt.pair_idx, rj.pair_idx)
    np.testing.assert_allclose(rt.corrected_tdoa_samples,
                               rj.corrected_tdoa_samples, atol=0.05)
    assert rt.excluded_stations == rj.excluded_stations == ["st4"]
    _assert_warnings_agree(rt.warnings, rj.warnings)
    assert (rt.ghost is None) == (rj.ghost is None)
    if rj.ghost is not None:
        assert (rt.ghost.best, rt.ghost.decided) == (rj.ghost.best,
                                                     rj.ghost.decided)
    truth = _exact_tdoas(sc.station_lla, sc.tgt_tx_lla)[0] * sc.sample_rate
    by_name = {tuple(sc.station_names[k] for k in p): t
               for p, t in zip(station_pairs(5), truth)}
    for k, (i, j) in enumerate(rt.pair_idx):
        a, b = names[i], names[j]
        if "st4" in (a, b):
            continue
        want = by_name[(a, b)] if (a, b) in by_name else -by_name[(b, a)]
        assert abs(rt.corrected_tdoa_samples[k] - want) < 0.5, (a, b)
    assert fix_error_m(rt.fix, sc.tgt_tx_lla) < 150.0
