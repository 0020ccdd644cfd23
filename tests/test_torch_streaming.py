"""The checkpointable accumulator and the tracker of
``tdoa_tpu_torch.pipeline.streaming`` against ``tdoa_tpu.pipeline.streaming``
on the same numpy-seeded inputs: chunk updates on the segmented geometry
and on kernel 1's geometry (the JAX side through its Pallas kernel in
interpret mode), every rung of the finalize's σ ladder, checkpoints
crossing between the packages both ways, and one scripted run of windows
through both trackers."""

import json

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90, fm_block, noise_block  # noqa: F401

try:  # the card's machine has no JAX: there only the `cuda` tests run
    import jax
    import jax.numpy as jnp
    import tdoa_tpu.ops.pallas.corr_accum as jkernel
    import tdoa_tpu.utils.platform as jplatform
    from tdoa_tpu.io import datfile as jdat
    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.pipeline import streaming as js
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.io import datfile as tdat
from tdoa_tpu_torch.pipeline import streaming as ts

PAIRS = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
# The overlapped ingest's 9 pairs over 3 stacked blocks of 3 rows.
STACKED_PAIRS = np.concatenate([PAIRS + 3 * b for b in range(3)])
SEG, MAX_LAG = 1 << 13, 128
FFT = 1 << 14  # next_pow2(SEG + MAX_LAG)
CHUNK = 2 * SEG
K_SEG, K_FFT = 45056, 65536  # kernel 1's geometry


# ---- the u16 decode ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_u16_decode_is_bit_equal(dtype):
    """Every byte value in both lanes: the port's decode of the packed
    words equals the JAX decode bit for bit, in f32 and in bf16."""
    rng = np.random.default_rng(0)
    raw = np.concatenate([
        np.repeat(np.arange(256, dtype=np.uint8), 2),
        rng.integers(0, 256, 2 * 4096, dtype=np.uint8)])
    words = tdat.iq_bytes_as_u16(raw)
    np.testing.assert_array_equal(words, jdat.iq_bytes_as_u16(raw))
    rows = np.stack([words, words[::-1]])  # [2 rows, L]
    want = jdat.u16_to_iq_planar(jnp.asarray(rows), dtype=getattr(jnp, dtype))
    got = tdat.u16_to_iq_planar(torch.from_numpy(rows),
                                dtype=getattr(torch, dtype))
    assert got.shape == (2, 2, rows.shape[1]) and got.dtype == getattr(
        torch, dtype)
    for k, part in enumerate((want.re, want.im)):
        np.testing.assert_array_equal(
            got[k].to(torch.float32).numpy(),
            np.asarray(part.astype(jnp.float32)))
    # and the u8 decode of the same bytes, the batch path's
    flat = tdat.bytes_to_iq_planar(torch.from_numpy(raw),
                                   dtype=getattr(torch, dtype))
    assert torch.equal(got[:, 0], flat)


# ---- acc_update / acc_finalize on the segmented geometry --------------

def _signal(n_chunks, seed=6, dc=(0.0, 0.0)):
    return noise_block(3, n_chunks * CHUNK, [0.0, 11.5, -7.25], seed=seed,
                       noise=0.2, dc=dc)


def _run_jax(x, n_chunks, remove_dc, seg=SEG, fft=FFT, chunk=CHUNK,
             dtype="float32", **kw):
    st = js.acc_init(3, 3, fft)
    for c in range(n_chunks):
        sl = x[:, :, c * chunk:(c + 1) * chunk]
        st = js.acc_update(
            st, C(jnp.asarray(sl[0], getattr(jnp, dtype)),
                  jnp.asarray(sl[1], getattr(jnp, dtype))),
            jnp.asarray(PAIRS), seg, fft, remove_dc=remove_dc, **kw)
    return st


def _run_port(x, n_chunks, remove_dc, seg=SEG, fft=FFT, chunk=CHUNK,
              dtype=torch.float32, device="cpu"):
    st = ts.acc_init(3, 3, fft, device)
    for c in range(n_chunks):
        sl = torch.from_numpy(x[:, :, c * chunk:(c + 1) * chunk])
        st = ts.acc_update(st, sl.to(device=device, dtype=dtype), PAIRS, seg,
                           fft, remove_dc=remove_dc)
    return st


def _slot_counts(st):
    return [int(v) for v in (st.n_seg, st.n_seg_a, st.n_seg_b, st.n_seg_c,
                             st.n_chunks)]


# n_chunks → the rung the finalize reaches.
RUNGS = {"sigma4": 4, "k2": 3, "single": 1}


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("remove_dc", [False, True])
def test_update_and_finalize_match_jax(rung, remove_dc):
    """Chunk updates and the finalize on the segmented geometry, f32:
    the same slot counts, delays within 2e-3 samples, σ within 2e-4
    samples + 1 % (the wideband scene's σ is 1e-3 to 7e-2 samples, the
    model's or the slot probes' spread), qualities within 1e-3
    relative."""
    n_chunks = RUNGS[rung]
    x = _signal(n_chunks, dc=(0.03, -0.02) if remove_dc else (0.0, 0.0))
    sj = _run_jax(x, n_chunks, remove_dc)
    sp = _run_port(x, n_chunks, remove_dc)
    assert _slot_counts(sp) == _slot_counts(sj)
    counts = [sp.n_seg_a, sp.n_seg_b, sp.n_seg_c,
              sp.n_seg - sp.n_seg_a - sp.n_seg_b - sp.n_seg_c]
    assert (min(counts) >= 2) == (rung == "sigma4")
    assert (counts[0] + counts[2] > 0 and counts[1] + counts[3] > 0) == (
        rung != "single")
    rj = js.acc_finalize(sj, jnp.asarray(PAIRS), MAX_LAG)
    rp = ts.acc_finalize(sp, PAIRS, MAX_LAG)
    np.testing.assert_allclose(rp.delay.numpy(), np.asarray(rj.delay),
                               atol=2e-3)
    np.testing.assert_allclose(rp.delay_std.numpy(), np.asarray(rj.delay_std),
                               atol=2e-4, rtol=1e-2)
    np.testing.assert_allclose(rp.quality.numpy(), np.asarray(rj.quality),
                               rtol=1e-3)
    np.testing.assert_allclose(rp.delay.numpy()[:2], [11.5, -7.25], atol=0.1)
    if rung != "single":  # the empirical floor is live on both sides
        model = ts.acc_finalize(
            sp._replace(n_seg_a=0, n_seg_b=0, n_seg_c=0, n_chunks=0,
                        cross_a=sp.cross_a * 0, cross_b=sp.cross_b * 0,
                        cross_c=sp.cross_c * 0), PAIRS, MAX_LAG)
        assert torch.all(rp.delay_std >= model.delay_std)


def test_sigma4_rung_sees_a_corrupted_slot():
    """One slot's signal replaced by noise: the four-slot σ (kernel 2's
    function fed the full-state PSD) inflates as the reference's does,
    within 2e-3 samples + 1 %."""
    x = _signal(4)
    rng = np.random.default_rng(8)
    x[:, :, CHUNK:2 * CHUNK] = rng.standard_normal((2, 3, CHUNK)).astype(
        np.float32)
    rj = js.acc_finalize(_run_jax(x, 4, False), jnp.asarray(PAIRS), MAX_LAG)
    clean = ts.acc_finalize(_run_port(_signal(4), 4, False), PAIRS, MAX_LAG)
    rp = ts.acc_finalize(_run_port(x, 4, False), PAIRS, MAX_LAG)
    np.testing.assert_allclose(rp.delay_std.numpy(), np.asarray(rj.delay_std),
                               atol=2e-3, rtol=1e-2)
    assert float(rp.delay_std.max()) > 3.0 * float(clean.delay_std.max())


def test_finalize_weighting_none_and_phat_match_jax():
    """The ladder's other weightings: "none" returns the plain finish,
    "phat" takes the torch probe (kernel 2's formula is HT's); delays
    within 2e-3 samples, σ within 2e-3 + 1 %."""
    x = _signal(4)
    sj, sp = _run_jax(x, 4, False), _run_port(x, 4, False)
    for weighting in ("none", "phat"):
        rj = js.acc_finalize(sj, jnp.asarray(PAIRS), MAX_LAG,
                             weighting=weighting)
        rp = ts.acc_finalize(sp, PAIRS, MAX_LAG, weighting=weighting)
        np.testing.assert_allclose(rp.delay.numpy(), np.asarray(rj.delay),
                                   atol=2e-3)
        np.testing.assert_allclose(rp.delay_std.numpy(),
                                   np.asarray(rj.delay_std),
                                   atol=2e-3, rtol=1e-2)


def test_ragged_chunk_is_refused():
    st = ts.acc_init(3, 3, FFT, "cpu")
    with pytest.raises(ValueError, match="not a multiple of seg_len"):
        ts.acc_update(st, torch.zeros(2, 3, SEG + 1), PAIRS, SEG, FFT)


def test_update_leaves_the_old_state_valid():
    """The update returns a new state; the one it was given still
    finalizes to what it did before (checkpoint-then-continue)."""
    x = _signal(2)
    s1 = _run_port(x, 1, False)
    before = ts.acc_finalize(s1, PAIRS, MAX_LAG).delay.clone()
    s2 = ts.acc_update(s1, torch.from_numpy(x[:, :, CHUNK:]), PAIRS, SEG, FFT)
    assert s1.n_chunks == 1 and s2.n_chunks == 2
    assert torch.equal(ts.acc_finalize(s1, PAIRS, MAX_LAG).delay, before)


# ---- kernel 1's geometry ----------------------------------------------

def test_kernel_geometry_matches_jax_pallas_update(monkeypatch):
    """3 stations × 2 chunks × 2 segments of 45056, bf16 operands, DC
    removal on: JAX ``acc_update`` routed through its Pallas kernel
    (``on_tpu`` patched, interpret mode) against the port's update
    through kernel 1's plain version. Delays within 5e-3 samples (bf16
    operands; the TPU kernel also rounds its DFT operands to bf16)."""
    x = fm_block(3, 4 * K_SEG, [0.0, 40.4, -41.6], seed=3, dc=(0.02, -0.01))
    pt = tuple(map(tuple, PAIRS.tolist()))
    monkeypatch.setattr(jplatform, "on_tpu", lambda: True)
    monkeypatch.setattr(jkernel, "default_interpret_mode", lambda: True)
    jax.clear_caches()  # the routing is decided at trace time
    try:
        sj = _run_jax(x, 2, True, seg=K_SEG, fft=K_FFT, chunk=2 * K_SEG,
                      dtype="bfloat16", pairs_static=pt, precision="bf16")
        rj = js.acc_finalize(sj, jnp.asarray(PAIRS), 512)
        dj, stdj = np.asarray(rj.delay), np.asarray(rj.delay_std)
    finally:
        jax.clear_caches()
    assert ts.kernel_geometry(3, PAIRS, K_SEG, K_FFT, 2 * K_SEG, True,
                              torch.device("cpu"))
    sp = _run_port(x, 2, True, seg=K_SEG, fft=K_FFT, chunk=2 * K_SEG,
                   dtype=torch.bfloat16)
    rp = ts.acc_finalize(sp, PAIRS, 512)
    assert _slot_counts(sp) == _slot_counts(sj) == [4, 2, 2, 0, 2]
    np.testing.assert_allclose(rp.delay.numpy(), dj, atol=5e-3)
    np.testing.assert_allclose(rp.delay_std.numpy(), stdj, rtol=0.05)


def test_kernel_geometry_gate():
    """Kernel 1 takes a chunk only at its own geometry and from one
    whole segment up; anything else goes to the segmented accumulator."""
    cpu = torch.device("cpu")
    p9 = STACKED_PAIRS
    assert ts.kernel_geometry(9, p9, K_SEG, K_FFT, 48 * K_SEG, True, cpu)
    assert not ts.kernel_geometry(9, p9, K_SEG, K_FFT, K_SEG - 1, True, cpu)
    assert not ts.kernel_geometry(9, p9, SEG, FFT, 48 * SEG, True, cpu)
    assert not ts.kernel_geometry(9, p9, K_SEG, 2 * K_FFT, 48 * K_SEG, True,
                                  cpu)


def test_kernel_route_is_decided_once_per_shape(monkeypatch):
    """On a card the footprint is asked once per shape: a stream's later
    chunks go the way its first went, whatever memory is free by then."""
    from tdoa_tpu_torch.ops.kernels import corr_accum as tkernel

    asked = []

    def fits(n_st, pairs, track_sums, n_banks, device):
        asked.append((n_st, pairs, track_sums, n_banks, device))
        return len(asked) == 1  # free memory "dips" after the first call

    monkeypatch.setattr(tkernel, "fits_device", fits)
    ts._kernel_fits.cache_clear()
    try:
        card = torch.device("cuda", 0)
        for n_seg in (96, 59, 96):
            assert ts.kernel_geometry(9, STACKED_PAIRS, K_SEG, K_FFT,
                                      n_seg * K_SEG, True, card)
        assert asked == [(9, tkernel.pairs_key(STACKED_PAIRS), True, 1,
                          card)]
        assert not ts.kernel_geometry(3, PAIRS, K_SEG, K_FFT, 96 * K_SEG,
                                      True, card)
        assert len(asked) == 2
    finally:
        ts._kernel_fits.cache_clear()


# ---- checkpoints cross between the packages ---------------------------

def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX ``acc_save`` → port ``acc_load`` → the next chunk → the same
    finalize as the uninterrupted JAX run (delays within 2e-3)."""
    x = _signal(4)
    path = str(tmp_path / "jax.npz")
    js.acc_save(path, _run_jax(x, 3, False))
    sp = ts.acc_load(path, device="cpu")
    assert _slot_counts(sp) == [6, 2, 2, 2, 3]
    sp = ts.acc_update(sp, torch.from_numpy(x[:, :, 3 * CHUNK:]), PAIRS, SEG,
                       FFT)
    rp = ts.acc_finalize(sp, PAIRS, MAX_LAG)
    rj = js.acc_finalize(_run_jax(x, 4, False), jnp.asarray(PAIRS), MAX_LAG)
    np.testing.assert_allclose(rp.delay.numpy(), np.asarray(rj.delay),
                               atol=2e-3)
    np.testing.assert_allclose(rp.delay_std.numpy(), np.asarray(rj.delay_std),
                               atol=2e-3, rtol=1e-2)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """Port ``acc_save`` → JAX ``acc_load`` → the next chunk → the same
    finalize as the uninterrupted port run; and the port's own round trip
    is bitwise."""
    x = _signal(4)
    path = str(tmp_path / "port.npz")
    s3 = _run_port(x, 3, False)
    ts.acc_save(path, s3)
    back = ts.acc_load(path, device="cpu")
    assert _slot_counts(back) == _slot_counts(s3)
    for a, b in zip(back, s3):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    sj = js.acc_load(path)
    last = x[:, :, 3 * CHUNK:]
    sj = js.acc_update(sj, C(jnp.asarray(last[0]), jnp.asarray(last[1])),
                       jnp.asarray(PAIRS), SEG, FFT)
    rj = js.acc_finalize(sj, jnp.asarray(PAIRS), MAX_LAG)
    rp = ts.acc_finalize(_run_port(x, 4, False), PAIRS, MAX_LAG)
    np.testing.assert_allclose(np.asarray(rj.delay), rp.delay.numpy(),
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(rj.delay_std), rp.delay_std.numpy(),
                               atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("era", ["pre-split", "two-slot"])
def test_old_checkpoints_load_like_the_reference(tmp_path, era):
    """Files from before the split slots (no slot fields: model σ only)
    and from the two-slot era (slot A only: the K = 2 rung) load and
    finalize in the port as in the reference."""
    x = _signal(4)
    sj = _run_jax(x, 4, False)
    keep = ["cross_re", "cross_im", "psd", "energy", "n_seg"]
    fields = {k: np.asarray(getattr(sj, k)) for k in keep}
    if era == "two-slot":
        # even-parity chunks were slot A
        fields.update(
            cross_re_a=np.asarray(sj.cross_re_a + sj.cross_re_c),
            cross_im_a=np.asarray(sj.cross_im_a + sj.cross_im_c),
            n_seg_a=np.asarray(sj.n_seg_a + sj.n_seg_c),
            n_chunks=np.asarray(sj.n_chunks))
    path = str(tmp_path / "old.npz")
    np.savez(path, **fields)
    sp, so = ts.acc_load(path, device="cpu"), js.acc_load(path)
    assert _slot_counts(sp) == _slot_counts(so)
    assert sp.n_seg_a == (4 if era == "two-slot" else 0)
    rp = ts.acc_finalize(sp, PAIRS, MAX_LAG)
    ro = js.acc_finalize(so, jnp.asarray(PAIRS), MAX_LAG)
    np.testing.assert_allclose(rp.delay.numpy(), np.asarray(ro.delay),
                               atol=2e-3)
    np.testing.assert_allclose(rp.delay_std.numpy(), np.asarray(ro.delay_std),
                               atol=2e-3, rtol=1e-2)


# ---- the tracker ------------------------------------------------------

STATIONS = np.array([
    [41.18660274289527, -95.96064116595667, 355.69],
    [41.24669616513154, -96.08366304481238, 329.0],
    [41.32916620016985, -96.03513381562004, 373.18],
    [41.26, -95.90, 340.0],
])


def _tdoas(tx_lla):
    from tdoa_tpu_torch.geo import lla_to_ecef
    from tdoa_tpu_torch.solve.multilateration import station_pairs
    from tdoa_tpu_torch.utils.constants import SPEED_OF_LIGHT

    pairs = station_pairs(len(STATIONS))
    d = np.linalg.norm(lla_to_ecef(STATIONS) - lla_to_ecef(tx_lla), axis=-1)
    return (d[pairs[:, 1]] - d[pairs[:, 0]]) / SPEED_OF_LIGHT


def _script():
    """Windows for two targets: "A" re-solved from TDOAs (weights on some
    windows, an FDOA or a velocity measurement on others), "B" fed fixes
    with covariances (Kalman blend), an uncalibrated window on the Kalman
    track, three far-off windows (gate → coasts), then the re-acquire and
    two windows after it."""
    rng = np.random.default_rng(4)
    a0 = np.array([41.30, -96.02, 350.0])
    steps = []
    for k in range(12):
        a = a0 + np.array([2e-4 * k, -1e-4 * k, 0.0])
        if 6 <= k <= 9:  # "A" measures far away: coast ×3, then re-acquire
            a = a + np.array([0.08, 0.05, 0.0])
        kw = {"tdoas_s": {"A": _tdoas(a) + rng.normal(0, 5e-9, 6),
                          "B": _tdoas(a0)},
              "qualities": {"A": 10.0 + k, "B": 7.0}}
        pos_b = np.array([1500.0 + 12.0 * k, -800.0 + 5.0 * k, 0.0]) \
            + rng.normal(0, 20.0, 3)
        if 8 <= k <= 10:  # "B" jumps too, with covariances: Kalman coast
            pos_b = pos_b + np.array([9000.0, 4000.0, 0.0])
        kw["positions_enu"] = {"B": pos_b}
        if k != 4:  # window 4 is uncalibrated for "B"
            kw["covs_en"] = {"B": np.array([[400.0, 50.0], [50.0, 900.0]])
                             * (1.0 + 0.1 * k)}
        if k % 3 == 1:
            kw["weights"] = {"A": np.array([1.0, 1.0, 0.5, 1.0, 0.0, 1.0])}
        if k == 2:
            kw["fdoa_hz"] = {"A": np.array([1.5, -0.5, 0.25, -2.0, -1.25,
                                            0.75])}
            kw["carrier_hz"] = 101.9e6
        if k == 5:
            kw["velocity_enu"] = {"A": np.array([3.0, -4.0, 0.0])}
        steps.append((float(2 * k), kw))
    return steps


def test_tracker_matches_the_reference_on_a_scripted_run():
    """Every window of the script through both trackers: positions within
    1e-3 m of each other where the fix was handed in, and within 0.5 m
    where each tracker re-solved the TDOAs itself (two float32 LM solvers:
    the measured spread is centimetres); velocities within 1e-3 m/s +
    1e-6 relative of what those positions imply; gate, coast and
    re-acquire counters equal at every step; the JSON state round-trips
    into a tracker that continues identically."""
    tj, tp = js.TargetTracker(STATIONS), ts.TargetTracker(STATIONS)
    np.testing.assert_allclose(tp.origin, tj.origin, atol=1e-9)
    seen = {"coast": 0, "reacquire": 0, "kalman": 0}
    resumed = None
    for t, kw in _script():
        before = {tid: tr.coasts for tid, tr in tp.tracks.items()}
        tj.update(t, **kw)
        tp.update(t, **kw)
        if resumed is not None:
            resumed.update(t, **kw)
        assert set(tp.tracks) == set(tj.tracks) == {"A", "B"}
        for tid in ("A", "B"):
            a, b = tp.tracks[tid], tj.tracks[tid]
            assert (a.n_updates, a.coasts, a.n_rejected) == (
                b.n_updates, b.coasts, b.n_rejected), (t, tid)
            tol = 1e-3 if tid == "B" else 0.5
            np.testing.assert_allclose(a.pos_enu, b.pos_enu, atol=tol)
            np.testing.assert_allclose(a.vel_enu, b.vel_enu, atol=tol,
                                       rtol=1e-6)
            np.testing.assert_allclose(a.innov_ema_m, b.innov_ema_m,
                                       atol=2 * tol)
            assert (a.cov_p is None) == (b.cov_p is None)
            if a.cov_p is not None:
                np.testing.assert_allclose(a.cov_p, b.cov_p, rtol=1e-9)
            assert a.quality == b.quality and a.last_t == b.last_t
            seen["coast"] += a.coasts > before.get(tid, 0)
            seen["reacquire"] += (before.get(tid, 0) >= tp.max_coasts
                                  and a.coasts == 0)
        seen["kalman"] += tp.tracks["B"].cov_p is not None
        if t == 10.0:  # mid-run: state → JSON → a fresh tracker
            resumed = ts.TargetTracker(STATIONS)
            resumed.load_state_dict(json.loads(json.dumps(tp.state_dict())))
            js_state = json.loads(json.dumps(tj.state_dict()))
            assert set(js_state) == set(tp.state_dict())
            assert set(js_state["A"]) == set(tp.state_dict()["A"])
    assert seen["coast"] >= 3 and seen["reacquire"] >= 1
    assert seen["kalman"] >= 10
    for tid in ("A", "B"):  # the resumed tracker continued identically
        np.testing.assert_array_equal(resumed.tracks[tid].pos_enu,
                                      tp.tracks[tid].pos_enu)
        np.testing.assert_array_equal(resumed.tracks[tid].vel_enu,
                                      tp.tracks[tid].vel_enu)
        assert resumed.tracks[tid].n_updates == tp.tracks[tid].n_updates


def test_tracker_state_crosses_between_the_packages():
    """A reference tracker's ``state_dict`` loads into the port's (and
    back) with the same tracks; a corrupted state is refused."""
    tj = js.TargetTracker(STATIONS)
    for t, kw in _script()[:4]:
        tj.update(t, **kw)
    tp = ts.TargetTracker(STATIONS)
    tp.load_state_dict(json.loads(json.dumps(tj.state_dict())))
    back = js.TargetTracker(STATIONS)
    back.load_state_dict(json.loads(json.dumps(tp.state_dict())))
    for tid in ("A", "B"):
        np.testing.assert_array_equal(tp.tracks[tid].pos_enu,
                                      tj.tracks[tid].pos_enu)
        np.testing.assert_array_equal(back.tracks[tid].vel_enu,
                                      tj.tracks[tid].vel_enu)
    bad = tp.state_dict()
    bad["A"]["pos_enu"] = [0.0, float("nan"), 0.0]
    with pytest.raises(ValueError, match="non-finite"):
        ts.TargetTracker(STATIONS).load_state_dict(bad)


# ---- on the card ------------------------------------------------------

@pytest.mark.cuda
def test_cuda_updates_match_cpu_updates(cuda_sm90, tmp_path):
    """Five bf16 chunks of 3 segments through kernel 1 on the card (one
    launch a chunk) against the same chunks on CPU tensors (its plain
    version): delays within 1e-3 samples, σ within 1e-3 relative + 2e-3
    (the σ₄ rung: kernel 2 on the card); a checkpoint saved from the card
    finalizes bitwise equal after loading back."""
    from tdoa_tpu_torch.ops.kernels.corr_accum import accumulate_banks
    from tdoa_tpu_torch.ops.kernels.zoom_probe import loo_zoom_windows

    x = fm_block(3, 15 * K_SEG, [0.0, 40.4, -41.6], seed=3, dc=(0.02, -0.01))
    n0, z0 = accumulate_banks.launches, loo_zoom_windows.launches
    kw = dict(seg=K_SEG, fft=K_FFT, chunk=3 * K_SEG, dtype=torch.bfloat16)
    sc = _run_port(x, 5, True, device=cuda_sm90, **kw)
    assert accumulate_banks.launches == n0 + 5
    rc = ts.acc_finalize(sc, PAIRS, 512)
    assert loo_zoom_windows.launches == z0 + 1
    rp = ts.acc_finalize(_run_port(x, 5, True, **kw), PAIRS, 512)
    np.testing.assert_allclose(rc.delay.cpu().numpy(), rp.delay.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(rc.delay_std.cpu().numpy(),
                               rp.delay_std.numpy(), rtol=1e-3, atol=2e-3)
    path = str(tmp_path / "card.npz")
    ts.acc_save(path, sc)
    again = ts.acc_finalize(ts.acc_load(path, device=cuda_sm90), PAIRS, 512)
    for a, b in zip(again, rc):
        assert torch.equal(a, b)
