"""Kernel 4 of the port (the multistart LM solve in one launch,
``tdoa_tpu_torch/ops/kernels/lm_solve.py``) against its plain version,
``solve_tdoa_enu``'s loop on CPU tensors, on the same float32 inputs.

The CPU tests hold the dispatch (a CPU device is the plain loop, bit for
bit, and launches nothing), the host-side packing of the one copy in and
out, and the wrapper's checks; the ``cuda`` tests run the kernel."""

import numpy as np
import pytest
import torch

from _torch_port_helpers import KEVO_LLA, NET24_LLA, cuda_sm90, pair_tdoas  # noqa: F401
from tdoa_tpu_torch.geo import lla_to_enu, network_origin
from tdoa_tpu_torch.ops.kernels import lm_solve as k4
from tdoa_tpu_torch.ops.kernels.lm_solve import lm_solve
from tdoa_tpu_torch.solve import multilateration as ml
from tdoa_tpu_torch.utils.constants import SPEED_OF_LIGHT

OMAHA3 = NET24_LLA[:3]
OUTSIDE_LLA = np.array([41.05, -96.30, 350.0])
# (stations, transmitter, solve_z, weights: None, "random" or a list).
CASES = {
    "m3-2d": (OMAHA3, KEVO_LLA, False, [1.0, 0.8, 0.6]),
    "m3-2d-outside": (OMAHA3, OUTSIDE_LLA, False, None),
    "m3-3d": (OMAHA3, KEVO_LLA, True, [1.0, 0.8, 0.6]),
    "m3-zero-weight": (OMAHA3, KEVO_LLA, False, [1.0, 0.0, 0.6]),
    "m276-2d": (NET24_LLA, KEVO_LLA, False, "random"),
    "m276-3d": (NET24_LLA, OUTSIDE_LLA, True, "random"),
}
# A start's rms above this is an unconverged stray (solve_fix's gate at
# its floor): strays land anywhere and are not compared.
STRAY_RMS = 50.0


def _case(name, seed=3):
    lla, tx, solve_z, w = CASES[name]
    tdoa = pair_tdoas(lla, tx, 2e-9, seed)
    if isinstance(w, str):
        w = np.random.default_rng(seed + 10).uniform(0.5, 1.0, len(tdoa))
    return lla, tdoa, solve_z, (None if w is None else np.asarray(w))


def _enu_inputs(lla, tdoa, w):
    """``solve_tdoa_enu``'s inputs as ``solve_fix`` makes them, with the
    multistart's starts (unsorted)."""
    enu = torch.from_numpy(
        lla_to_enu(lla, network_origin(lla)).astype(np.float32))
    pairs = torch.from_numpy(ml.station_pairs(len(lla)).astype(np.int64))
    rd = torch.from_numpy((tdoa * SPEED_OF_LIGHT).astype(np.float32))
    wt = None if w is None else torch.from_numpy(w.astype(np.float32))
    return enu, pairs, rd, wt, ml.multistart_starts(enu)


def _fields(fix):
    return (fix.lat, fix.lon, fix.elev, fix.enu, fix.rms_residual_m,
            fix.candidates_lla, fix.candidates_rms, fix.cov_en, fix.ellipse)


def _kernel_inputs(m=3, S=9, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 1e4)
    return t(m, 3), t(m, 3), t(m), t(m).abs(), t(S, 3)


# ---- CPU: the dispatch, the packing, the checks -----------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_device_is_the_plain_solve_bitwise(name):
    """``device="cpu"`` is the call without it: every field of the fix
    bitwise equal, and kernel 4 never launched."""
    lla, tdoa, solve_z, w = _case(name)
    kw = dict(weights=w, solve_z=solve_z, tdoa_sigma_s=np.full(len(tdoa),
                                                               5e-9))
    before = lm_solve.launches
    want = ml.solve_fix(lla, tdoa, **kw)
    got = ml.solve_fix(lla, tdoa, device="cpu", **kw)
    assert lm_solve.launches == before
    for a, b in zip(_fields(got), _fields(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("single", [False, True], ids=["ring", "one-start"])
def test_cpu_solve_tdoa_enu_takes_the_plain_loop(single):
    enu, pairs, rd, w, starts = _enu_inputs(*_case("m3-2d")[:2],
                                            np.array([1.0, 0.8, 0.6]))
    x0 = starts[0] if single else starts
    want = ml.solve_tdoa_enu(enu, pairs, rd, weights=w, x0=x0)
    got = ml.solve_tdoa_enu(enu, pairs, rd, weights=w, x0=x0,
                            device=torch.device("cpu"))
    assert got[0].shape == ((3,) if single else (9, 3))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,S", [(1, 1), (3, 9), (276, 9), (7, 32)])
def test_pack_and_unpack_round_trip(m, S):
    """The packed input holds each pair as ``si.xyz, rd | sj.xyz, w`` and
    then the starts; an output row ``x, y, z, rms`` unpacks to the
    position and the rms."""
    si, sj, rd, w, x0 = _kernel_inputs(m, S, seed=m + S)
    buf = np.full(k4.input_floats(m, S) + 5, np.nan, np.float32)
    k4.pack_inputs(buf, si.numpy(), sj.numpy(), rd.numpy(), w.numpy(),
                   x0.numpy())
    pairs = buf[:8 * m].reshape(m, 2, 4)
    assert np.array_equal(pairs[:, 0, :3], si.numpy())
    assert np.array_equal(pairs[:, 0, 3], rd.numpy())
    assert np.array_equal(pairs[:, 1, :3], sj.numpy())
    assert np.array_equal(pairs[:, 1, 3], w.numpy())
    starts = buf[8 * m:8 * m + 4 * S].reshape(S, 4)
    assert np.array_equal(starts[:, :3], x0.numpy())
    assert np.all(starts[:, 3] == 0.0)
    assert np.isnan(buf[k4.input_floats(m, S):]).all()  # nothing beyond
    rms = torch.arange(S, dtype=torch.float32)
    out = torch.cat([x0, rms[:, None]], 1).reshape(-1).numpy()
    x, r = k4.unpack_outputs(out)
    assert torch.equal(x, x0) and torch.equal(r, rms)
    out[:] = np.nan  # the results are copies, not views of the buffer
    assert torch.equal(x, x0) and torch.equal(r, rms)


def _bad_inputs(what):
    si, sj, rd, w, x0 = _kernel_inputs()
    args = dict(si=si, sj=sj, rd=rd, w=w, x0=x0, iters=40, n_dim=2)
    if what == "f64":
        args["rd"] = rd.double()
    elif what == "si-shape":
        args["si"] = si[:, :2]
    elif what == "w-shape":
        args["w"] = w[:2]
    elif what == "no-pairs":
        args.update(si=si[:0], sj=sj[:0], rd=rd[:0], w=w[:0])
    elif what == "33-starts":
        args["x0"] = torch.zeros(33, 3)
    elif what == "one-start-unbatched":
        args["x0"] = x0[0]
    elif what == "n_dim":
        args["n_dim"] = 4
    elif what == "iters":
        args["iters"] = -1
    return args


BAD = ["f64", "si-shape", "w-shape", "no-pairs", "33-starts",
       "one-start-unbatched", "n_dim", "iters"]


@pytest.mark.parametrize("what", BAD)
def test_wrapper_rejects_what_the_kernel_does_not_take(what):
    """Checked before any device is touched: a ValueError, no launch."""
    before = lm_solve.launches
    with pytest.raises(ValueError):
        lm_solve(**_bad_inputs(what), device="cuda")
    assert lm_solve.launches == before


def test_wrapper_raises_for_a_device_that_is_not_a_card():
    """No fallback: the wrapper launches the kernel or raises."""
    si, sj, rd, w, x0 = _kernel_inputs()
    before = lm_solve.launches
    with pytest.raises(RuntimeError, match="not a CUDA device"):
        lm_solve(si, sj, rd, w, x0, 40, 2, "cpu")
    assert lm_solve.launches == before


def _tracker_inputs(lla):
    """Range differences and weights ``[k, m]`` of two targets, KEVO and
    one outside the network, as the tracker's ``_solve_batch`` takes
    them."""
    rd = np.stack([pair_tdoas(lla, tx, 2e-9, k) * SPEED_OF_LIGHT
                   for k, tx in enumerate((KEVO_LLA, OUTSIDE_LLA))])
    w = np.random.default_rng(5).uniform(0.5, 1.0, rd.shape)
    return rd, w


@pytest.mark.parametrize("lla", [OMAHA3, NET24_LLA], ids=["m3", "m276"])
def test_tracker_on_the_cpu_takes_the_plain_loop(lla):
    """The tracker solves on its ``device``: the CPU, its default, is the
    plain loop bit for bit, with no launch."""
    from tdoa_tpu_torch.pipeline.streaming import TargetTracker

    rd, w = _tracker_inputs(lla)
    before = lm_solve.launches
    want = TargetTracker(lla)._solve_batch(rd, w)
    got = TargetTracker(lla, device=torch.device("cpu"))._solve_batch(rd, w)
    assert lm_solve.launches == before
    np.testing.assert_array_equal(got, want)


# ---- the card ---------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_start_by_start(cuda_sm90, name):
    """Every start of the 9-start ring, unsorted: each start that both
    versions converge (rms under ``STRAY_RMS``) has the same rms within
    0.05 m, and the same position within 0.5 m (horizontally with
    ``solve_z`` at 24 stations; with it at 3 stations the up-coordinate
    is unobservable and a start's point drifts along a flat valley, so
    only its rms is held there)."""
    lla, tdoa, solve_z, w = _case(name)
    enu, pairs, rd, wt, starts = _enu_inputs(lla, tdoa, w)
    kw = dict(weights=wt, x0=starts, solve_z=solve_z)
    x_p, r_p = ml.solve_tdoa_enu(enu, pairs, rd, **kw)
    before = lm_solve.launches
    x_k, r_k = ml.solve_tdoa_enu(enu, pairs, rd, device=cuda_sm90, **kw)
    assert lm_solve.launches == before + 1
    assert x_k.device.type == "cpu" and x_k.shape == (9, 3)
    conv = (r_p < STRAY_RMS) & (r_k < STRAY_RMS)
    assert bool(conv[0]), "the centroid start converges"
    np.testing.assert_allclose(r_k[conv], r_p[conv], atol=0.05)
    if not solve_z:
        assert torch.equal(x_k[:, 2], starts[:, 2])  # frozen
    if not (solve_z and len(lla) == 3):
        n = 2 if solve_z else 3
        d = (x_k[conv, :n] - x_p[conv, :n]).norm(dim=-1)
        assert float(d.max()) < 0.5


@pytest.mark.cuda
def test_kernel_takes_a_single_start(cuda_sm90):
    lla, tdoa, _, w = _case("m3-2d")
    enu, pairs, rd, wt, starts = _enu_inputs(lla, tdoa, w)
    x_p, r_p = ml.solve_tdoa_enu(enu, pairs, rd, weights=wt, x0=starts[0])
    x_k, r_k = ml.solve_tdoa_enu(enu, pairs, rd, weights=wt, x0=starts[0],
                                 device=cuda_sm90)
    assert x_k.shape == (3,) and r_k.dim() == 0
    assert float((x_k - x_p).norm()) < 0.5 and abs(float(r_k - r_p)) < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_fix_on_the_card_matches_plain(cuda_sm90, name):
    """After ``solve_fix``'s sort, de-duplication and gate: the same
    number of candidates, the same leading candidate (within 0.5 m, and
    its rms within 0.05 m), one launch a solve."""
    lla, tdoa, solve_z, w = _case(name)
    kw = dict(weights=w, solve_z=solve_z,
              tdoa_sigma_s=np.full(len(tdoa), 5e-9))
    want = ml.solve_fix(lla, tdoa, **kw)
    before = lm_solve.launches
    got = ml.solve_fix(lla, tdoa, device=cuda_sm90, **kw)
    assert lm_solve.launches == before + 1
    assert len(got.candidates_rms) == len(want.candidates_rms)
    assert abs(got.rms_residual_m - want.rms_residual_m) < 0.05
    n = 2 if solve_z else 3
    if not (solve_z and len(lla) == 3):
        assert np.linalg.norm(got.enu[:n] - want.enu[:n]) < 0.5


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda_sm90):
    """Every sum is a fixed butterfly: two launches agree bitwise."""
    lla, tdoa, _, w = _case("m276-2d")
    enu, pairs, rd, wt, starts = _enu_inputs(lla, tdoa, w)
    a = ml.solve_tdoa_enu(enu, pairs, rd, weights=wt, x0=starts,
                          device=cuda_sm90)
    b = ml.solve_tdoa_enu(enu, pairs, rd, weights=wt, x0=starts,
                          device=cuda_sm90)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("what", BAD + ["cuda-tensors"])
def test_wrapper_raises_on_the_card(cuda_sm90, what):
    args = _bad_inputs(None if what == "cuda-tensors" else what)
    if what == "cuda-tensors":
        args["rd"] = args["rd"].to(cuda_sm90)
    before = lm_solve.launches
    with pytest.raises(ValueError):
        lm_solve(**args, device=cuda_sm90)
    assert lm_solve.launches == before


@pytest.mark.cuda
def test_zero_iterations_return_the_starts(cuda_sm90):
    """``iters`` 0 runs no step: the starts come back with their rms."""
    si, sj, rd, w, x0 = _kernel_inputs(m=5, S=4, seed=7)
    x, rms = lm_solve(si, sj, rd, w, x0, 0, 2, cuda_sm90)
    assert torch.equal(x, x0)
    di = (x0[:, None] - si[None]).norm(dim=-1)
    dj = (x0[:, None] - sj[None]).norm(dim=-1)
    r = (dj - di) - rd
    want = torch.sqrt((w * r * r).sum(-1) / w.sum())
    torch.testing.assert_close(rms, want, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("lla", [OMAHA3, NET24_LLA], ids=["m3", "m276"])
def test_tracker_solves_on_its_card(cuda_sm90, lla):
    """A tracker on the card: one launch a target, each fix within 0.5 m
    of the plain loop's (one start, the centroid)."""
    from tdoa_tpu_torch.pipeline.streaming import TargetTracker

    rd, w = _tracker_inputs(lla)
    want = TargetTracker(lla)._solve_batch(rd, w)
    before = lm_solve.launches
    got = TargetTracker(lla, device=cuda_sm90)._solve_batch(rd, w)
    assert lm_solve.launches == before + len(rd)
    assert np.linalg.norm(got - want, axis=-1).max() < 0.5
