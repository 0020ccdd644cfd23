"""The port's segmented correlator (``tdoa_tpu_torch/ops/corr.py``:
``resolve_seg``, ``auto_seg_len``, ``correlate_pairs_planar``,
``correlate_pairs``, ``correlate_two``) against ``tdoa_tpu.ops.corr`` on
the same numpy-seeded signals.

Tolerance: delays within 2e-3 samples (f32 operands, the ``ROADMAP.md``
tolerance), σs within 5 % relative. Both sides transform the same f32
segments; the sums over segments run in another order, and the port's
HT split-σ probe takes kernel 2's plain version where the JAX planar
path takes its XLA form (which also divides by the per-row max weight,
a scale that moves no peak).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import fm_block
from tdoa_tpu.ops import corr as jcorr
from tdoa_tpu.ops.cplx import C
from tdoa_tpu_torch.ops import corr as tcorr

PAIRS = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
SEG = 8192  # configured segment; resolve_seg shrinks it by max_lag
MAX_LAG = 512


def test_resolve_seg_and_auto_seg_len_match():
    """Equal on a grid of (n, max_lag, seg_len), raising cases included."""
    for n in (1000, 4096, 45055, 100_000, 1 << 20):
        for max_lag in (0, 16, 512, 4096, 20000, 40000):
            for seg in (None, 1024, 4096, 1 << 14, 1 << 16):
                for fft in (None, 1 << 15):
                    try:
                        want = jcorr.resolve_seg(n, max_lag, seg, fft)
                    except ValueError as e:
                        with pytest.raises(ValueError, match=str(e)[:12]):
                            tcorr.resolve_seg(n, max_lag, seg, fft)
                        continue
                    assert tcorr.resolve_seg(n, max_lag, seg, fft) == want
                assert tcorr.auto_seg_len(n, max_lag, seg) == \
                    jcorr.auto_seg_len(n, max_lag, seg)
    for k in (1, 2, 3, 4095, 4096, 4097):
        assert tcorr.next_pow2(k) == jcorr.next_pow2(k)
    np.testing.assert_array_equal(tcorr.correlation_lags(7),
                                  jcorr.correlation_lags(7))


# Segment counts 1, 5 and 9 of the shrunk 7680-sample segment: K = 0,
# 2 and 4 split banks.
@pytest.fixture(scope="module", params=[1, 5, 9], ids=["K0", "K2", "K4"])
def block(request):
    n = request.param * (SEG - MAX_LAG) + 300
    return fm_block(3, n, [0.0, 33.75, -11.5], seed=request.param, noise=0.2,
                    dc=(0.01, -0.02))


@pytest.mark.parametrize("weighting", ["none", "phat", "scot", "ht"])
def test_correlate_pairs_planar_matches_jax(block, weighting):
    rj = jcorr.correlate_pairs_planar(
        C(jnp.asarray(block[0]), jnp.asarray(block[1])), jnp.asarray(PAIRS),
        max_lag=MAX_LAG, seg_len=SEG, weighting=weighting)
    rt = tcorr.correlate_pairs_planar(torch.from_numpy(block), PAIRS,
                                      max_lag=MAX_LAG, seg_len=SEG,
                                      weighting=weighting)
    np.testing.assert_allclose(rt.delay.numpy(), np.asarray(rj.delay),
                               atol=2e-3)
    np.testing.assert_allclose(rt.delay_std.numpy(),
                               np.asarray(rj.delay_std), rtol=0.05)
    np.testing.assert_allclose(rt.quality.numpy(), np.asarray(rj.quality),
                               rtol=1e-3)
    np.testing.assert_allclose(rt.peak_value.numpy(),
                               np.asarray(rj.peak_value), rtol=1e-3)
    assert rt.corr.shape == (3, 2 * MAX_LAG + 1)


def test_whole_signal_correlation_matches_jax():
    """seg_len=None: one FFT of the whole signal, padded to
    next_pow2(n + max_lag)."""
    b = fm_block(3, 20_000, [0.0, 7.25, -3.5], seed=7, noise=0.1)
    rj = jcorr.correlate_pairs_planar(
        C(jnp.asarray(b[0]), jnp.asarray(b[1])), jnp.asarray(PAIRS),
        max_lag=256, seg_len=None, weighting="phat")
    rt = tcorr.correlate_pairs_planar(torch.from_numpy(b), PAIRS,
                                      max_lag=256, weighting="phat")
    np.testing.assert_allclose(rt.delay.numpy(), np.asarray(rj.delay),
                               atol=2e-3)
    np.testing.assert_allclose(rt.delay_std.numpy(),
                               np.asarray(rj.delay_std), rtol=0.05)


def test_correlate_pairs_and_two_take_complex_input():
    b = fm_block(3, 4 * SEG, [0.0, 21.5, -8.25], seed=8, noise=0.2)
    z = (b[0] + 1j * b[1]).astype(np.complex64)
    rj = jcorr.correlate_pairs(jnp.asarray(z), jnp.asarray(PAIRS),
                               max_lag=MAX_LAG, seg_len=SEG, weighting="ht")
    rt = tcorr.correlate_pairs(z, PAIRS, max_lag=MAX_LAG, seg_len=SEG,
                               weighting="ht")
    np.testing.assert_allclose(rt.delay.numpy(), np.asarray(rj.delay),
                               atol=2e-3)
    tj = jcorr.correlate_two(jnp.asarray(z[0]), jnp.asarray(z[1]),
                             max_lag=MAX_LAG, seg_len=SEG, weighting="ht")
    tt = tcorr.correlate_two(z[0], torch.from_numpy(b[:, 1]),
                             max_lag=MAX_LAG, seg_len=SEG, weighting="ht")
    assert tt.delay.shape == ()
    np.testing.assert_allclose(float(tt.delay), float(tj.delay), atol=2e-3)
    np.testing.assert_allclose(float(tt.delay_std), float(tj.delay_std),
                               rtol=0.05)


def test_chunked_accumulation_equals_one_chunk(monkeypatch):
    """Bounding memory by chunks of segments changes no result beyond
    float32 summation order."""
    b = torch.from_numpy(fm_block(3, 9 * SEG, [0.0, 5.0, -5.0], seed=9))
    one = tcorr._accumulate_cross_spectra(b, PAIRS, SEG, 2 * SEG)
    monkeypatch.setattr(tcorr, "SEG_CHUNK_BYTES", 1)  # one segment a chunk
    many = tcorr._accumulate_cross_spectra(b, PAIRS, SEG, 2 * SEG)
    for a, c in zip(one, many):
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(a.abs().max()))
