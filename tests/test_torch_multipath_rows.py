"""The port's lobe statistics and top-k peaks over whole windows
(``dsp/multipath.py``, ``solve/association.top_k_peaks``), held bitwise
to the reference package's row-at-a-time NumPy definitions
(``tdoa_tpu.dsp.multipath``, ``tdoa_tpu.solve.association``): a window's
magnitudes, argmax and median floor taken over a few rows at a time,
and the exclusion zone sliced per row, must not move a single bit of
what each row gives on its own. The port reads complex64 windows as
their complex128 widening, so those cases are held to the reference on
the widened windows. The windows: clean and echoed lobes, peaks at the
edges, a NaN, odd and even lag counts, complex64, complex128 and real
rows."""

from __future__ import annotations

import numpy as np
import pytest

from tdoa_tpu.dsp import multipath as ref_mp
from tdoa_tpu.solve.association import top_k_peaks as ref_top_k_peaks
from tdoa_tpu_torch.dsp import multipath as mp
from tdoa_tpu_torch.solve.association import top_k_peaks


def _windows(seed, m, n_lags, dtype, edge=False, nan=False):
    """Lag windows of m pairs: a lobe of random width and phase, an echo
    12 lags behind at 0.3, complex noise; peaks near both edges and a
    NaN on request."""
    rng = np.random.default_rng(seed)
    lag = np.arange(n_lags) - n_lags // 2
    pk = rng.integers(-n_lags // 3, n_lags // 3, m)
    if edge:
        pk[:3] = [-n_lags // 2 + 5, n_lags // 2 - 10, -n_lags // 2]
    width = rng.uniform(1.0, 5.0, (m, 1))
    x = (np.exp(-0.5 * ((lag[None] - pk[:, None]) / width) ** 2)
         + 0.3 * np.exp(-0.5 * ((lag[None] - pk[:, None] - 12) / 3.0) ** 2))
    x = x * np.exp(1j * rng.uniform(0.0, 6.0, (m, 1)))
    x = x + 0.02 * (rng.normal(size=(m, n_lags))
                    + 1j * rng.normal(size=(m, n_lags)))
    if nan:
        x[1, 7] = np.nan
    if dtype == "real":
        return np.abs(x)
    return x.astype(dtype)


CASES = [(n, dt, edge, nan)
         for n in (40001, 1025, 1024)
         for dt in (np.complex64, np.complex128, "real")
         for edge, nan in ((False, False), (True, True))]
IDS = [f"{n}-{np.dtype(dt).name if dt != 'real' else 'real'}"
       f"{'-edge-nan' if edge else ''}" for n, dt, edge, nan in CASES]


def _same(a, b):
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def _as_read(win):
    """The windows as the port reads them: complex64 widened."""
    return win.astype(np.complex128) if win.dtype == np.complex64 else win


@pytest.mark.parametrize("n_lags,dtype,edge,nan", CASES, ids=IDS)
def test_lobe_statistics_are_their_rows(n_lags, dtype, edge, nan):
    win = _windows(n_lags, 21, n_lags, dtype, edge, nan)
    other = _windows(n_lags + 1, 21, n_lags, dtype, edge, nan)
    drift, offset = mp.lobe_centroid_drift_offset(win)
    assert _same(drift, ref_mp.lobe_centroid_drift(_as_read(win)))
    assert _same(offset, ref_mp.lobe_centroid_offset(_as_read(win)))
    assert _same(mp.lobe_centroid_drift(win), drift)
    assert _same(mp.lobe_centroid_offset(win), offset)
    assert _same(mp.ref_lobe_echo_consistency(win, other),
                 ref_mp.ref_lobe_echo_consistency(_as_read(win),
                                                  _as_read(other)))


@pytest.mark.parametrize("n_lags", [40001, 1024, 130])
def test_complex64_ref_consistency_is_the_widened_magnitudes(n_lags):
    """Complex64 lag windows read what the magnitudes of their
    complex128 widening give, as the processor's whole-array widening
    did."""
    a = _windows(3, 19, n_lags, np.complex64, edge=True)
    b = _windows(4, 19, n_lags, np.complex64)
    want = ref_mp.ref_lobe_echo_consistency(
        np.abs(a.astype(np.complex128)), np.abs(b.astype(np.complex128)))
    assert _same(mp.ref_lobe_echo_consistency(a, b), want)


@pytest.mark.parametrize("guard", [None, 0, 3, 50, 10 ** 6])
@pytest.mark.parametrize("n_lags", [40001, 64, 9])
def test_top_k_peaks_is_the_masked_search(n_lags, guard):
    win = np.abs(_windows(n_lags + 7, 17, n_lags, np.complex128))
    win[0, :3] = 50.0
    win[1, -2:] = 60.0
    win[2] = 0.0
    for k in (1, 2, 4):
        got = top_k_peaks(win, k, guard)
        want = ref_top_k_peaks(win, k, guard)
        assert _same(got.lag, want.lag) and _same(got.value, want.value)
