"""The port's sequence-parallel path (``tdoa_tpu_torch/parallel/``)
against the JAX package's (``tdoa_tpu.parallel``) on the same inputs.

The reference runs on the 8-virtual-device CPU mesh of
``tests/conftest.py`` (its fused kernel in interpret mode, f32); the
port runs in ONE spawned world of 8 gloo ranks on the CPU
(``_torch_parallel_cases.run_cases``, started in a thread while the
reference computes), each case on a mesh of the first n ranks, kernel
1's plain version on every rank's chunk. Delays agree within 2e-3
samples, the f32 tolerance between the reference's own kernels and its
XLA paths (``tests/test_fused_corr.py``)."""

import threading

import numpy as np
import pytest
import torch

import _torch_parallel_cases
from _torch_port_helpers import cuda_sm90  # noqa: F401

try:  # the card's machine has no JAX: there only the `cuda` test runs
    import jax
    import jax.numpy as jnp
    from tdoa_tpu.ops.cplx import C, from_complex
    from tdoa_tpu.parallel import correlate_pairs_sharded as jax_corr
    from tdoa_tpu.parallel import make_mesh as jax_mesh
    from tdoa_tpu.parallel import process_blocks_sharded as jax_blocks
    from tdoa_tpu.sim import SimScene, fm_source, fractional_delay
    from tdoa_tpu.sim import simulate_scene
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.ops.kernels.corr_accum import FFT_LEN, SEG_LEN
from tdoa_tpu_torch.parallel import (
    correlate_pairs_sharded,
    make_mesh,
    process_blocks_sharded,
)
from tdoa_tpu_torch.parallel.dryrun import demo_blocks
from tdoa_tpu_torch.parallel.launch import spawn
from tdoa_tpu_torch.parallel.mesh import Mesh

WORLD = 8
TOL = 2e-3  # samples
PAIRS3 = ((0, 1), (0, 2), (1, 2))
# The reference deployment (lat-lon-table.csv), as tests/conftest.py's
# omaha_stations fixture gives it.
OMAHA_LLA = np.array([
    [41.18660274289527, -95.96064116595667, 355.69],
    [41.24669616513154, -96.08366304481238, 329.0],
    [41.32916620016985, -96.03513381562004, 373.18],
])
REF_TX = np.array([41.25703803095629, -95.95512763589404, 349.07])
TGT_TX = np.array([41.30888549464701, -96.02619229605524, 356.0])
# tests/test_multistation.py's six stations: the three above and three
# more within ~15 km.
SIX_LLA = np.vstack([OMAHA_LLA, [[41.26, -95.90, 340.0],
                                 [41.36, -96.12, 360.0],
                                 [41.20, -96.16, 345.0]]])
SIX_CLOCKS_S = np.array([5e-6, -9e-6, 14e-6, -2e-6, 7e-6, -4e-6])
# The six-station step: 4 kernel segments a block (one a rank at 4 ranks)
# on both routes.
SIX_LEN = 4 * SEG_LEN
SIX_OPTS = {"xla": {"max_lag": 512, "seg_len": 1 << 13},
            "pallas": {"max_lag": 512, "accumulator": "pallas"}}
# A block whose kernel segments 2 and 4 ranks do not divide: 9 of them
# and a 100 s block's ragged tail (28,842 samples), as a 100 s block's
# 1479 segments are not divided: the ranks keep 8, the rest is dropped.
RAGGED_LEN = 9 * SEG_LEN + 28_842
H100_SMEM_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin


def _planar(sigs):
    """Complex JAX signals → (the reference's planar C, numpy [2, n, N])."""
    x = np.stack([np.asarray(s) for s in sigs]).astype(np.complex64)
    re, im = x.real.astype(np.float32), x.imag.astype(np.float32)
    return C(jnp.asarray(re), jnp.asarray(im)), np.stack([re, im])


def _three(key_seed, n):
    base = fm_source(jax.random.PRNGKey(key_seed), n, 2e6)
    return _planar([base, fractional_delay(base, jnp.float32(17.25)),
                    fractional_delay(base, jnp.float32(-33.5))])


def _split_inputs():
    """tests/test_parallel.py's split-half σ case: a clean two-station
    capture, and three copies whose second half is noise."""
    n = 1 << 16
    base = fm_source(jax.random.PRNGKey(2), n, 2e6)
    xj, _ = _planar([base, fractional_delay(base, jnp.float32(9.5))])
    kr, ki = jax.random.split(jax.random.PRNGKey(3))
    xj = C(xj.re + 0.2 * jax.random.normal(kr, xj.re.shape, jnp.float32),
           xj.im + 0.2 * jax.random.normal(ki, xj.im.shape, jnp.float32))
    clean = np.stack([np.asarray(xj.re), np.asarray(xj.im)])
    m = np.zeros(n, np.float32)
    m[n // 2:] = 1.0
    wrecks = []
    for ks in (4, 5, 6):
        kw = np.asarray(jax.random.normal(jax.random.PRNGKey(ks), (2, n, 2),
                                          jnp.float32))
        wrecks.append(np.stack([clean[0] * (1 - m) + kw[..., 0] * m,
                                clean[1] * (1 - m) + kw[..., 1] * m]))
    return xj, clean, wrecks


def _scene_blocks(lla=OMAHA_LLA, block_len=1 << 16,
                  clocks=np.array([7e-6, -5e-6, 11e-6]), seed=5):
    """tests/test_parallel.py's end-to-end scene (omaha geometry, 2^16
    samples a block; or another network): the reference's planar
    blocks, the port's numpy blocks, pairs, REF geometric TDOAs and the
    truth."""
    from tdoa_tpu.geo import lla_to_ecef
    from tdoa_tpu.utils.constants import SPEED_OF_LIGHT

    names = ("kx0u", "n3pay", "kf0mtl", "st4", "st5", "st6")[:len(lla)]
    scene = SimScene(station_names=names, station_lla=lla,
                     ref_tx_lla=REF_TX, tgt_tx_lla=TGT_TX,
                     block_len=block_len, clock_offsets_s=clocks, seed=seed)
    captures, truth = simulate_scene(scene)
    jblocks, tblocks = [], []
    for i in range(3):
        parts = [from_complex(captures[n][i]) for n in names]
        jblocks.append(C(jnp.stack([b.re for b in parts]),
                         jnp.stack([b.im for b in parts])))
        tblocks.append(np.stack([np.asarray(jblocks[-1].re),
                                 np.asarray(jblocks[-1].im)]))
    st = lla_to_ecef(lla)
    tau = np.linalg.norm(st - lla_to_ecef(REF_TX), axis=-1) \
        / SPEED_OF_LIGHT * 2e6
    p = truth.pair_idx
    ref_geo = (tau[p[:, 1]] - tau[p[:, 0]]).astype(np.float32)
    return jblocks, tblocks, np.asarray(p), ref_geo, truth


@pytest.fixture(scope="module")
def world():
    """(the port's results by case, the reference's, the inputs)."""
    x_j, x_np = _three(0, 1 << 16)
    xp_j, xp_np = _three(3, SEG_LEN * 8)
    split_j, split_clean, split_wrecks = _split_inputs()
    jblocks, tblocks, p, ref_geo, truth = _scene_blocks()
    six = _scene_blocks(SIX_LLA, SIX_LEN, SIX_CLOCKS_S, seed=61)
    rag = _scene_blocks(block_len=RAGGED_LEN, seed=67)
    xla = {"max_lag": 128, "seg_len": 1 << 12, "weighting": "ht"}
    cases = []
    for n in (2, 8):
        cases += [
            (f"xla{n}", "corr", n,
             {"x": x_np, "pairs": PAIRS3, "opts": xla}),
            (f"pallas{n}", "corr", n,
             {"x": xp_np, "pairs": PAIRS3,
              "opts": {"max_lag": 128, "accumulator": "pallas"}}),
            (f"blocks{n}", "blocks", n,
             {"blocks": tblocks, "pairs": p, "ref_geo": ref_geo,
              "opts": {"max_lag": 256, "seg_len": 1 << 13}}),
        ]
    for n in (2, 4):
        for route, opts in SIX_OPTS.items():
            cases.append((f"six_{route}{n}", "blocks", n,
                          {"blocks": six[1], "pairs": six[2],
                           "ref_geo": six[3], "opts": opts}))
            cases.append((f"ragged_{route}{n}", "blocks", n,
                          {"blocks": rag[1], "pairs": rag[2],
                           "ref_geo": rag[3], "opts": opts}))
    for k, xs in enumerate([split_clean, *split_wrecks]):
        cases.append((f"split{k}", "corr", 8,
                      {"x": xs, "pairs": ((0, 1),), "opts": xla}))
    cases += [("dryrun2", "dryrun", 2, {}), ("dryrun4", "dryrun", 4, {})]

    box = {}

    def run():
        try:
            box["port"] = spawn(_torch_parallel_cases.run_cases, WORLD,
                                "cpu", cases, "cpu")[0]
        except Exception as e:  # re-raised below, in the test's thread
            box["error"] = e

    ranks = threading.Thread(target=run)
    ranks.start()
    ref = {}
    for n in (2, 8):
        mesh = jax_mesh(n)
        ref[f"xla{n}"] = jax_corr(x_j, jnp.asarray(PAIRS3), mesh, **xla)
        ref[f"pallas{n}"] = jax_corr(xp_j, jnp.asarray(PAIRS3), mesh,
                                     max_lag=128, accumulator="pallas",
                                     pairs_static=PAIRS3)
        ref[f"blocks{n}"] = jax_blocks(
            *jblocks, jnp.asarray(p), jnp.asarray(ref_geo), mesh,
            max_lag=256, seg_len=1 << 13)
    ref["split0"] = jax_corr(split_j, jnp.asarray([[0, 1]]), jax_mesh(8),
                             **xla)
    pairs6 = tuple(map(tuple, six[2].tolist()))
    for n in (2, 4):
        for route, opts in SIX_OPTS.items():
            extra = {"pairs_static": pairs6} if route == "pallas" else {}
            ref[f"six_{route}{n}"] = jax_blocks(
                *six[0], jnp.asarray(six[2]), jnp.asarray(six[3]),
                jax_mesh(n), **opts, **extra)
            extra = ({"pairs_static": tuple(map(tuple, rag[2].tolist()))}
                     if route == "pallas" else {})
            ref[f"ragged_{route}{n}"] = jax_blocks(
                *rag[0], jnp.asarray(rag[2]), jnp.asarray(rag[3]),
                jax_mesh(n), **opts, **extra)
    ranks.join(timeout=900)
    assert not ranks.is_alive(), "the spawned world did not finish"
    if "error" in box:
        raise box["error"]
    return box["port"], ref, {"truth": truth, "six_truth": six[4],
                              "ragged_truth": rag[4]}


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="launch.spawn"):
        make_mesh(device="cpu")


def test_refusals_match_the_reference():
    """The reference's three ValueErrors of the kernel route (no pairs,
    a lag beyond the kernel's alias-free window, a chunk shorter than
    one segment), raised before any collective."""
    mesh = Mesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    x = torch.zeros(2, 3, 4 * SEG_LEN)
    with pytest.raises(ValueError, match="no pairs"):
        correlate_pairs_sharded(x, (), mesh, accumulator="pallas")
    with pytest.raises(ValueError, match="alias-free"):
        correlate_pairs_sharded(x, PAIRS3, mesh, accumulator="pallas",
                                max_lag=FFT_LEN - SEG_LEN + 1)
    with pytest.raises(ValueError, match="shorter than one kernel segment"):
        correlate_pairs_sharded(x[..., :SEG_LEN], PAIRS3, mesh,
                                accumulator="pallas", max_lag=128)
    with pytest.raises(ValueError, match="shorter than one kernel segment"):
        process_blocks_sharded(x[..., :SEG_LEN], x[..., :SEG_LEN],
                               x[..., :SEG_LEN], PAIRS3, np.zeros(3), mesh,
                               accumulator="pallas", max_lag=128)


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("n", [2, 8])
def test_correlate_pairs_sharded_matches_reference(world, route, n):
    port, ref, _ = world
    got, want = port[f"{route}{n}"], ref[f"{route}{n}"]
    np.testing.assert_allclose(got["delay"], np.asarray(want.delay),
                               atol=TOL)
    np.testing.assert_allclose(got["delay"], [17.25, -33.5, -50.75],
                               atol=0.1)
    assert np.all(got["delay_std"] > 0)


@pytest.mark.parametrize("n", [2, 8])
def test_process_blocks_sharded_matches_reference(world, n):
    port, ref, inputs = world
    got = port[f"blocks{n}"]["corrected"]
    np.testing.assert_allclose(got, np.asarray(ref[f"blocks{n}"][0]),
                               atol=TOL)
    np.testing.assert_allclose(got, inputs["truth"].tgt_tdoa_samples,
                               atol=0.6)


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("n", [2, 4])
def test_six_station_sharded_step_matches_reference(world, route, n):
    """The full sharded step at 6 stations (18 stacked rows, 45 pairs) on
    both routes at 2 and 4 ranks: corrected TDOAs within 2e-3 samples of
    the JAX mesh's (its kernel in interpret mode on the kernel route)
    and 0.6 of the truth, every σ > 0."""
    port, ref, inputs = world
    got = port[f"six_{route}{n}"]
    np.testing.assert_allclose(got["corrected"],
                               np.asarray(ref[f"six_{route}{n}"][0]),
                               atol=TOL)
    np.testing.assert_allclose(got["corrected"],
                               inputs["six_truth"].tgt_tdoa_samples,
                               atol=0.6)
    assert np.all(got["corrected_std"] > 0)


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_on_a_block_the_ranks_do_not_divide(world, route, n):
    """The full sharded step on blocks of 9 kernel segments and a ragged
    tail over 2 and 4 ranks (each keeps 4 or 2 segments, the ninth and
    the tail dropped, as 2 and 4 ranks drop a 100 s block's last
    segments), both routes: corrected TDOAs within 2e-3 samples of the
    JAX mesh's on the same blocks and 0.6 of the truth, every σ > 0."""
    port, ref, inputs = world
    got = port[f"ragged_{route}{n}"]
    np.testing.assert_allclose(got["corrected"],
                               np.asarray(ref[f"ragged_{route}{n}"][0]),
                               atol=TOL)
    np.testing.assert_allclose(got["corrected"],
                               inputs["ragged_truth"].tgt_tdoa_samples,
                               atol=0.6)
    assert np.all(got["corrected_std"] > 0)


@pytest.mark.parametrize("n_st,launches", [(3, 1), (6, 1), (12, 3), (16, 6)])
def test_sharded_rows_tile_at_h100_optin(n_st, launches):
    """The sharded step's kernel-1 call (3 stacked blocks of n_st rows,
    f32, one bank, no DC sums) planned at the H100's opt-in limit: one
    launch to 6 stations (18 rows, 45 pairs), a launch per 12-row block
    at 12 stations, tiles within each 16-row block at 16; every launch
    within the limit, its pairs within its rows, all pairs once in
    order."""
    from tdoa_tpu_torch.ops.kernels import corr_accum

    base = [(i, j) for i in range(n_st) for j in range(i + 1, n_st)]
    pairs = [(i + b * n_st, j + b * n_st) for b in range(3) for i, j in base]
    plan = corr_accum.plan_tiles(pairs, 3 * n_st, False, H100_SMEM_OPTIN)
    assert len(plan) == launches
    assert [t[2] for t in plan] == [0] + [t[3] for t in plan[:-1]]
    assert plan[-1][3] == len(pairs)
    for r0, r1, lo, hi in plan:
        assert corr_accum.smem_bytes(r1 - r0, hi - lo, False) \
            <= H100_SMEM_OPTIN
        assert all(r0 <= i < r1 and r0 <= j < r1 for i, j in pairs[lo:hi])


def test_split_sigma_clean_and_corrupted(world):
    """tests/test_parallel.py's split-half σ on the port: ranks ≥ d/2
    hold the second half through the masked all-reduce. Clean: the
    reference's delay within 2e-3, σ below half a sample; the second
    half replaced by noise (three draws): σ inflates past 3× the clean
    one (and 0.5), the delay stays within 5 samples."""
    port, ref, _ = world
    clean = port["split0"]
    np.testing.assert_allclose(clean["delay"], np.asarray(ref["split0"].delay),
                               atol=TOL)
    assert abs(float(clean["delay"][0]) - 9.5) < 0.1
    s_clean = float(clean["delay_std"][0])
    assert 0.0 < s_clean < 0.5, s_clean
    s_wrecks = []
    for k in (1, 2, 3):
        wreck = port[f"split{k}"]
        assert abs(float(wreck["delay"][0]) - 9.5) < 5.0
        s_wrecks.append(float(wreck["delay_std"][0]))
    assert max(s_wrecks) > max(3.0 * s_clean, 0.5), (s_wrecks, s_clean)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_certificate(world, n):
    """``parallel.dryrun`` at n ranks: the 3-station scene at every mesh
    size up to n, the 5-station scene and kernel 1 per rank at n, each
    within 1e-3 samples of one device."""
    report = world[0][f"dryrun{n}"]
    sizes = [k for k in (2, 4) if k <= n]
    assert set(report) == ({f"xla n={k} (3 st)" for k in sizes}
                           | {f"xla n={n} (5 st)", f"pallas n={n}"})
    assert max(report.values()) < 1e-3, report


@pytest.mark.cuda
def test_cuda_sharded_full_step_matches_cpu(cuda_sm90):
    """The sharded full step on the card (2 ranks sharing it through
    gloo; kernel 1 and kernel 2 on each) against the same world on the
    CPU (the kernels' plain versions): corrected TDOAs within 2e-3
    samples of each other and 0.5 sample of the planted 7, 14, 7 (the
    smoke's truth bound), σ within 10 %."""
    blocks = [b.numpy() for b in demo_blocks(length=SEG_LEN * 8, seed=3)]
    cases = [(f"{route}2", "blocks", 2,
              {"blocks": blocks, "pairs": PAIRS3, "ref_geo": np.zeros(3),
               "opts": {"max_lag": 128, "accumulator": route,
                        "seg_len": 1 << 14}})
             for route in ("pallas", "xla")]
    got = {dev: spawn(_torch_parallel_cases.run_cases, 2, dev, cases, dev)[0]
           for dev in ("cuda", "cpu")}
    for name, _, _, _ in cases:
        a, b = got["cuda"][name], got["cpu"][name]
        np.testing.assert_allclose(a["corrected"], b["corrected"], atol=TOL)
        np.testing.assert_allclose(a["corrected"], [7.0, 14.0, 7.0],
                                   atol=0.5)
        np.testing.assert_allclose(a["corrected_std"], b["corrected_std"],
                                   rtol=0.1)
