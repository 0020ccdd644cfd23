"""The collector's longest window, 100 s (``cli/collector.py``'s
``MAX_DURATION_S``): three blocks of 66,666,666 samples, 1479 whole
kernel segments and a ragged tail of 28,842 samples each. The port's
geometry at that length against the JAX package's, on the CPU:

- the split banks, the segmented route's segment and the overlapped
  ingest's chunks of a 100 s block;
- the block length and decode type ``load_files`` takes from a 400 MB
  file's size (a sparse file, neither written nor read);
- a small capture with the 100 s block's ragged tail through
  ``process_blocks`` of both packages, on the kernel route (the port's
  plain version against the reference's Pallas kernels in interpret
  mode) and on the segmented route;
- the phase-slope refinement on spectra as large as a strong signal's
  over a 100 s block;
- on the card: the segmented route's memory beyond its blocks, one f32
  stack of them.
"""

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90, noise_block  # noqa: F401

try:  # the card's machine has no JAX: this file runs on the CPU only
    import jax
    import jax.numpy as jnp
    from tdoa_tpu.cli import collector as jcollector
    from tdoa_tpu.io import datfile as jdatfile
    from tdoa_tpu.ops import corr as jcorr
    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.pipeline import ingest as jingest
    from tdoa_tpu.pipeline import processor as jprocessor
    from tdoa_tpu.utils import platform as jplatform
except ModuleNotFoundError:
    pass
from test_torch_pipeline import CSV, OMAHA
from tdoa_tpu_torch.cli import collector as tcollector
from tdoa_tpu_torch.io.datfile import DatCapture
from tdoa_tpu_torch.ops import corr as tcorr
from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN, bank_bounds
from tdoa_tpu_torch.pipeline import ingest as tingest
from tdoa_tpu_torch.pipeline import processor as tprocessor

FILE_BYTES = 400_000_000  # a 100 s capture: 3 × 66,666,666 samples × 2 bytes
BLOCK = 66_666_666
SEGS = 1479  # whole kernel segments of a 100 s block
TAIL = BLOCK - SEGS * SEG_LEN  # 28,842 samples the kernel route drops
MAX_LAG = 20000
PAIRS = np.array([[0, 1], [0, 2], [1, 2]])


def test_the_collectors_longest_window_is_this_block():
    """Both collectors cap a capture at 100 s: three blocks of
    66,666,666 samples (400,000,000 bytes a file), 1479 whole kernel
    segments and 28,842 samples of ragged tail each."""
    assert tcollector.MAX_DURATION_S == jcollector.MAX_DURATION_S == 100
    assert tcollector.SAMPLE_RATE == jcollector.SAMPLE_RATE
    assert BLOCK == tcollector.MAX_DURATION_S * tcollector.SAMPLE_RATE // 3
    assert BLOCK == FILE_BYTES // (2 * 3)
    assert (SEGS, TAIL) == divmod(BLOCK, SEG_LEN) == (1479, 28_842)


def test_split_banks_of_a_100s_block_equal_the_reference():
    """K = 4 banks of 370/370/370/369 segments, in samples, as the
    reference's ``_split_bounds``; kernel 1's ``bank_bounds`` in
    segments says the same."""
    want = jcorr._split_bounds(SEGS, 4, SEG_LEN)
    assert tcorr.split_k(SEGS) == jcorr.split_k(SEGS) == 4
    assert tcorr._split_bounds(SEGS, 4, SEG_LEN) == want
    assert [b * SEG_LEN for b in bank_bounds(SEGS, 4)] == want
    assert np.diff(bank_bounds(SEGS, 4)).tolist() == [370, 370, 370, 369]


def test_segmented_geometry_of_a_100s_block_equals_the_reference():
    """The segmented route's segment at 66,666,666 samples, max_lag
    20000 and the processor's default segment: ``auto_seg_len`` keeps
    it, ``resolve_seg`` shrinks it to fit the lag window; the 1464
    segments split into the reference's banks."""
    seg = tprocessor.ProcessorConfig.seg_len
    assert seg == jprocessor.ProcessorConfig.seg_len
    auto = tcorr.auto_seg_len(BLOCK, MAX_LAG, seg)
    assert auto == jcorr.auto_seg_len(BLOCK, MAX_LAG, seg) == seg
    got = tcorr.resolve_seg(BLOCK, MAX_LAG, auto, None)
    assert got == tuple(jcorr.resolve_seg(BLOCK, MAX_LAG, auto, None))
    seg_len, fft_len = got
    assert (seg_len, fft_len) == (65536 - MAX_LAG, 65536)
    n_seg = BLOCK // seg_len
    assert n_seg == 1464
    assert tcorr._split_bounds(n_seg, 4, seg_len) == jcorr._split_bounds(
        n_seg, 4, seg_len)


def test_chunks_of_a_100s_block_cover_the_batch_segments():
    """The overlapped ingest's default chunks of a 100 s block: 15 of 96
    segments and a short last one of 39, the reference's layout at the
    same chunk size, covering exactly the batch route's 1479 whole
    segments (the ragged tail dropped)."""
    chunk, spans = tingest.plan_chunks(BLOCK, SEG_LEN)
    assert chunk == tingest.DEFAULT_CHUNK_SEGS * SEG_LEN == 96 * SEG_LEN
    assert [n // SEG_LEN for _, n in spans] == [96] * 15 + [39]
    j_chunk, j_spans = jingest.plan_chunks(BLOCK, SEG_LEN, chunk)
    assert (chunk, spans) == (j_chunk, [tuple(s) for s in j_spans])
    starts = [s for s, _ in spans]
    assert starts == [k * chunk for k in range(16)]
    assert sum(n for _, n in spans) == SEGS * SEG_LEN
    assert starts[-1] + spans[-1][1] == BLOCK - TAIL


@pytest.fixture
def sparse_100s_files(tmp_path):
    """Three stations' 100 s captures as sparse files of 400,000,000
    bytes: sized, never written or read."""
    paths = []
    for name in OMAHA["names"]:
        p = tmp_path / f"{name}-1700000000.dat"
        with open(p, "wb") as fh:
            fh.truncate(FILE_BYTES)
        paths.append(str(p))
    return paths


def test_load_files_decides_a_100s_block_from_the_file_size(
        sparse_100s_files, monkeypatch):
    """``load_files`` takes the block length from each file's size and,
    through ``_fused_eligible``, decodes into bf16 for the kernel route:
    the reference's decision on its TPU route for the same files, and
    the block length of the reference's ``load_dat`` contract (its
    decode and block split, traced on the file's length alone)."""
    asked = {}

    def port_load(paths, stations=None, dtype=torch.float32, device=None,
                  diag=None, ring=None):
        asked.setdefault("port", []).extend([dtype] * len(paths))
        z = torch.zeros(2, 1, dtype=dtype)
        return [DatCapture(z, z, z, p, st) for p, st in zip(paths, stations)]

    def jax_load(path, station="", dtype=jnp.float32):
        asked.setdefault("jax", []).append(dtype)
        z = C(jnp.zeros(1, dtype), jnp.zeros(1, dtype))
        return jdatfile.DatCapture(z, z, z, path, station)

    eligible = {}
    port_eligible = tprocessor.TDOAProcessor._fused_eligible

    def spy(self, n_stations, min_block_samples):
        eligible[n_stations] = min_block_samples
        return port_eligible(self, n_stations, min_block_samples)

    monkeypatch.setattr(tprocessor, "load_window", port_load)
    monkeypatch.setattr(tprocessor.TDOAProcessor, "_fused_eligible", spy)
    monkeypatch.setattr(jprocessor, "load_dat", jax_load)
    monkeypatch.setattr(jplatform, "on_tpu", lambda: True)
    freqs = (OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV)
    caps = tprocessor.TDOAProcessor.from_csv(
        *freqs, device="cpu").load_files(sparse_100s_files)
    jprocessor.TDOAProcessor.from_csv(*freqs).load_files(sparse_100s_files)
    assert sorted(caps) == sorted(OMAHA["names"])
    assert eligible == {3: BLOCK}
    assert asked["port"] == [torch.bfloat16] * 3
    assert asked["jax"] == [jnp.bfloat16] * 3
    usable = (FILE_BYTES // (2 * 3)) * (2 * 3)
    ref1 = jax.eval_shape(
        lambda w: jdatfile.split_blocks(
            jdatfile.u16_to_iq_planar(w, dtype=jnp.bfloat16))[0].re,
        jax.ShapeDtypeStruct((usable // 2,), jnp.uint16))
    assert ref1.shape == (BLOCK,) and ref1.dtype == jnp.bfloat16


# A small capture with the 100 s block's ragged tail: TARGET_SEGS whole
# kernel segments (the least the kernel route takes) and 28,842 samples
# more; the planted delays are fractional, REF and TGT apart.
SMALL = tcorr.TARGET_SEGS * SEG_LEN + TAIL
D_REF = (0.0, 37.3, -12.6)
D_TGT = (0.0, 101.25, -57.5)


@pytest.fixture(scope="module")
def ragged_blocks():
    """(ref1, tgt, ref2) planar f32 [2, 3, SMALL] of bf16-representable
    values (both packages' kernel routes store their operands in bf16),
    and the REF transmitter's geometric TDOA per pair (samples): zero,
    so the REF blocks' delays are all clock."""
    blocks = []
    for k, d in enumerate((D_REF, D_TGT, D_REF)):
        x = noise_block(3, SMALL, d, seed=90 + k, dc=(0.03, -0.02))
        blocks.append(torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    return blocks, np.zeros(len(PAIRS), np.float32)


def _truth():
    d = np.asarray(D_TGT) - np.asarray(D_REF)
    return d[PAIRS[:, 1]] - d[PAIRS[:, 0]]


def _jax_blocks(blocks, geo, accumulator, **kw):
    out = jprocessor.process_blocks(
        *(C(jnp.asarray(b[0]), jnp.asarray(b[1])) for b in blocks),
        jnp.asarray(PAIRS, jnp.int32), jnp.asarray(geo), max_lag=512,
        weighting="ht", accumulator=accumulator,
        pairs_static=tuple(map(tuple, PAIRS.tolist())), **kw)
    return [np.asarray(v) for v in out[:3]]


def _port_blocks(blocks, geo, accumulator, **kw):
    out = tprocessor.process_blocks(
        *(torch.from_numpy(b) for b in blocks), PAIRS,
        torch.from_numpy(geo), max_lag=512, weighting="ht",
        accumulator=accumulator, **kw)
    return [v.numpy() for v in out[:3]]


@pytest.mark.parametrize("route", ["kernel", "segmented"])
def test_ragged_tail_block_matches_the_reference(ragged_blocks, route):
    """Corrected TDOAs, TGT and REF delays within 2e-3 samples of the
    JAX package's on the same blocks (the kernel route: the port's plain
    version of kernels 1 and 2 against the reference's Pallas kernels
    in interpret mode; the segmented route at the processor's segment),
    and within 0.05 sample of the planted delays."""
    blocks, geo = ragged_blocks
    if route == "kernel":
        got = _port_blocks(blocks, geo, "pallas")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcorr, "_FORCE_PROBE_KERNEL", True)
            jax.clear_caches()  # the probe routing is decided at trace time
            try:
                want = _jax_blocks(blocks, geo, "pallas")
            finally:
                jax.clear_caches()
    else:
        seg = tprocessor.ProcessorConfig.seg_len
        got = _port_blocks(blocks, geo, "xla", seg_len=seg)
        want = _jax_blocks(blocks, geo, "xla", seg_len=seg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-3)
    np.testing.assert_allclose(got[0], _truth(), atol=0.05)


def test_kernel_route_drops_the_ragged_tail(ragged_blocks):
    """The kernel route correlates whole segments only: the ragged
    block's result is bitwise the result on its whole segments."""
    blocks, geo = ragged_blocks
    whole = [np.ascontiguousarray(b[..., :SMALL - TAIL]) for b in blocks]
    for g, w in zip(_port_blocks(blocks, geo, "pallas"),
                    _port_blocks(whole, geo, "pallas")):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("power", [25, 50])
def test_phase_slope_fit_holds_a_long_strong_capture(power):
    """The phase-slope refinement weighs bins by |C|², which grows with
    the square of the segment count: a strong coherent signal over a
    100 s block's 1479 segments overflowed float32 in the fit's
    fourth-power sums, and every delay of the kernel and segmented
    routes came out NaN on the card. Spectra 2^25 and 2^50 times a small
    capture's (its |C|² 2^50 and 2^100 times larger) give that capture's
    delays and σs bit for bit."""
    x = torch.from_numpy(noise_block(3, 8 * 65536, (0.0, 12.3, -40.7), 4))
    seg = 65536 - 512
    cross, psd, energy = tcorr._accumulate_cross_spectra(x, PAIRS, seg,
                                                         65536)
    want = tcorr._finish_correlation(cross, psd, energy, PAIRS, 512, "ht",
                                     1e-3, 65536, "phase", n_seg=8)
    k = float(2 ** power)
    got = tcorr._finish_correlation(cross * k, psd * k, energy * k, PAIRS,
                                    512, "ht", 1e-3, 65536, "phase",
                                    n_seg=8)
    assert torch.isfinite(got.delay).all()
    assert torch.equal(got.delay, want.delay)
    assert torch.equal(got.delay_std, want.delay_std)
    np.testing.assert_allclose(want.delay.numpy(), [12.3, -40.7, -53.0],
                               atol=0.01)


@pytest.mark.cuda
def test_cuda_segmented_route_holds_one_f32_stack(cuda_sm90):
    """The segmented route's peak device memory beyond its three bf16
    blocks is their f32 stack and the chunks and banks beside it: less
    than 1.5 stacks. Beside the stack it used to hold the blocks' stack
    in bf16 and three signal-sized RMS temporaries, 2.5 stacks more,
    which a 100 s window of 24 stations does not leave room for."""
    n_st, n = 12, 30_000_000
    g = torch.Generator(device=cuda_sm90).manual_seed(5)
    blocks = [torch.randn(2, n_st, n, generator=g, device=cuda_sm90)
              .to(torch.bfloat16) for _ in range(3)]
    pairs = np.array([(i, j) for i in range(n_st)
                      for j in range(i + 1, n_st)])
    geo = torch.zeros(len(pairs), device=cuda_sm90)
    stack = 2 * 3 * n_st * n * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_sm90)
    torch.cuda.reset_peak_memory_stats(cuda_sm90)
    out = tprocessor.process_blocks(
        *blocks, pairs, geo, max_lag=MAX_LAG,
        seg_len=tprocessor.ProcessorConfig.seg_len, weighting="ht",
        accumulator="xla")
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(cuda_sm90) - base
    assert torch.isfinite(out[0]).all()
    assert extra < 1.5 * stack, (extra / 1e9, stack / 1e9)
