"""Streaming correlation and multi-target tracking.

Torch port of ``tdoa_tpu.pipeline.streaming``:

1. **Incremental cross-spectrum accumulation**: the correlator's
   accumulator as explicit state (``AccState``). Feed capture chunks as
   they arrive (``acc_update``), checkpoint the state between chunks
   (``acc_save``/``acc_load``: it is O(fft_len) whatever has been
   integrated, and its ``.npz`` fields are the reference's, so either
   package resumes the other's checkpoint), and finalize to delays at
   any time (``acc_finalize`` leaves the state untouched). On the kernel
   geometry (FFT 65536, segment 45056) a chunk goes through kernel 1 as
   one bank (``ops/kernels/corr_accum.py``), any other geometry through
   the segmented accumulator (``ops/corr.py``); the four-slot σ probe of
   the finalize is kernel 2's function (``ops/kernels/zoom_probe.py``).

   Spectra are ``complex64`` tensors on the chunk's device. The segment
   counts and the slot selector are Python ints: the slot a chunk adds
   into is chosen on the host, and no update reads anything back from
   the device.

2. **Multi-target tracking** (``TargetTracker``): per-window fixes
   smoothed in the network's ENU frame, a Kalman position blend when the
   windows carry calibrated covariances and alpha-beta otherwise. Host
   arithmetic (numpy) around the float32 LM solver on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from tdoa_tpu_torch.geo import enu_to_lla, lla_to_enu, network_origin
from tdoa_tpu_torch.ops.corr import (
    _SPLIT_STD_SCALE,
    CorrResult,
    _accumulate_cross_spectra,
    _finish_correlation,
    _split_half_sigma,
    _weight_factor,
    _zoom_corr_delay,
)
from tdoa_tpu_torch.solve.multilateration import solve_tdoa_enu, station_pairs
from tdoa_tpu_torch.utils.constants import SPEED_OF_LIGHT
from tdoa_tpu_torch.utils.platform import default_device


class AccState(NamedTuple):
    """Checkpointable accumulator: everything needed to resume or
    finalize a long-running correlation."""

    cross: torch.Tensor  # [m, F] complex64
    psd: torch.Tensor  # [n_st, F]
    energy: torch.Tensor  # [n_st]
    # Integrated *segments* (samples = n_seg·seg_len).
    n_seg: int
    # Split-slot cross-spectra for the empirical error bar: update calls
    # rotate through slots A/B/C/D (D is total − A − B − C and is not
    # stored). Contiguous groups need the total duration up front —
    # unknowable in streaming — so the slots interleave by chunk: a
    # jackknife over time that sees realization noise and impairment
    # residue, though not slow drift. Four slots give the batch path's
    # 3-dof σ once all hold data; with only the even/odd pair populated
    # (2-3 chunks, or a two-slot-era checkpoint) the even (A+C) vs odd
    # (B+D) halves give the K=2 estimator.
    cross_a: torch.Tensor  # [m, F]
    n_seg_a: int
    n_chunks: int  # update calls so far: the slot selector
    cross_b: torch.Tensor
    n_seg_b: int
    cross_c: torch.Tensor
    n_seg_c: int


def acc_init(n_st: int, n_pairs: int, fft_len: int,
             device: Optional[torch.device] = None) -> AccState:
    """An empty accumulator on ``device`` (default: the card,
    ``utils.platform.default_device``)."""
    dev = default_device() if device is None else torch.device(device)

    def zero_mf():
        return torch.zeros(n_pairs, fft_len, dtype=torch.complex64, device=dev)

    return AccState(
        cross=zero_mf(),
        psd=torch.zeros(n_st, fft_len, dtype=torch.float32, device=dev),
        energy=torch.zeros(n_st, dtype=torch.float32, device=dev),
        n_seg=0,
        cross_a=zero_mf(), n_seg_a=0, n_chunks=0,
        cross_b=zero_mf(), n_seg_b=0,
        cross_c=zero_mf(), n_seg_c=0,
    )


def kernel_geometry(n_st: int, pairs, seg_len: int, fft_len: int,
                    length: int, remove_dc: bool,
                    device: torch.device) -> bool:
    """Whether a chunk of ``length`` samples over ``n_st`` rows goes
    through kernel 1 for ``pairs`` (host [m, 2]): its fixed geometry, at
    least one segment, and on CUDA the kernel's own single-bank
    launches of those pairs on ``device`` (decided at the first question
    for a shape, ``_kernel_fits``)."""
    from tdoa_tpu_torch.ops.kernels.corr_accum import (
        FFT_LEN,
        SEG_LEN,
        pairs_key,
    )

    ok = fft_len == FFT_LEN and seg_len == SEG_LEN and length >= SEG_LEN
    if ok and device.type == "cuda":
        index = (torch.cuda.current_device() if device.index is None
                 else device.index)
        ok = _kernel_fits(n_st, pairs_key(pairs), remove_dc, index)
    return ok


@functools.lru_cache(maxsize=None)
def _kernel_fits(n_st: int, pairs: tuple, remove_dc: bool,
                 index: int) -> bool:
    """``fits_device``'s verdict on kernel 1 as a single bank, taken once
    per shape and card and kept: every chunk of a stream then goes the
    way its first chunk went (a state never mixes the two accumulators,
    and no chunk queries the free memory of the card; the kernel's
    scratch, which grows with the chunk, is counted at the
    longest block a capture holds). A later chunk that the card cannot
    hold raises from the kernel's wrapper."""
    from tdoa_tpu_torch.ops.kernels.corr_accum import fits_device

    return fits_device(n_st, pairs, remove_dc, 1,
                       torch.device("cuda", index))


def acc_update(
    state: AccState,
    chunk: torch.Tensor,  # planar [2, n_st, L]; L a multiple of seg_len
    pair_idx,  # [m, 2]
    seg_len: int,
    fft_len: int,
    remove_dc: bool = False,
) -> AccState:
    """Integrate one capture chunk into the accumulator and return the
    new state (the old one stays valid). The chunk length must be a
    multiple of ``seg_len`` — a ragged tail would otherwise be dropped
    while still being counted.

    A chunk of the kernel geometry (``kernel_geometry``) is accumulated
    by kernel 1 as a single bank (pair-tiled where one launch does not
    hold the pairs), bf16 or f32 as it comes, with the DC
    removal folded into the spectra; any other chunk by the segmented
    accumulator in f32 after a per-chunk demean — the streaming
    counterpart of the batch path's per-block DC removal."""
    length = int(chunk.shape[-1])
    if length % seg_len:
        raise ValueError(
            f"chunk length {length} is not a multiple of "
            f"seg_len {seg_len}; pad or split the chunk"
        )
    n_st = int(chunk.shape[1])
    if kernel_geometry(n_st, pair_idx, seg_len, fft_len, length, remove_dc,
                       chunk.device):
        from tdoa_tpu_torch.ops.kernels.corr_accum import (
            accumulate_cross_spectra,
        )

        cross, psd, energy = accumulate_cross_spectra(
            chunk, pair_idx, remove_dc=remove_dc, n_splits=1)
    else:
        chunk = chunk.to(torch.float32)
        if remove_dc:
            chunk = chunk - chunk.mean(-1, keepdim=True)
        cross, psd, energy = _accumulate_cross_spectra(
            chunk, pair_idx, seg_len, fft_len)
    slot = state.n_chunks % 4
    segs = length // seg_len
    return AccState(
        cross=state.cross + cross,
        psd=state.psd + psd,
        energy=state.energy + energy,
        n_seg=state.n_seg + segs,
        cross_a=state.cross_a + cross if slot == 0 else state.cross_a,
        n_seg_a=state.n_seg_a + (segs if slot == 0 else 0),
        n_chunks=state.n_chunks + 1,
        cross_b=state.cross_b + cross if slot == 1 else state.cross_b,
        n_seg_b=state.n_seg_b + (segs if slot == 1 else 0),
        cross_c=state.cross_c + cross if slot == 2 else state.cross_c,
        n_seg_c=state.n_seg_c + (segs if slot == 2 else 0),
    )


_COUNTS = ("n_seg", "n_seg_a", "n_chunks", "n_seg_b", "n_seg_c")
_SLOTS = ("", "_a", "_b", "_c")


def acc_save(path: str, state: AccState) -> None:
    """Checkpoint the accumulator to a ``.npz`` file with the
    reference's field names (``cross_re``, ``cross_im``, …), so a
    checkpoint written by either package resumes in the other."""
    fields = {"psd": state.psd.cpu().numpy(),
              "energy": state.energy.cpu().numpy()}
    for s in _SLOTS:
        c = getattr(state, "cross" + s).cpu()
        fields["cross_re" + s] = c.real.numpy()
        fields["cross_im" + s] = c.imag.numpy()
    for k in _COUNTS:
        fields[k] = np.asarray(getattr(state, k), np.int32)
    np.savez(path, **fields)


def acc_load(path: str, device: Optional[torch.device] = None) -> AccState:
    """Resume an accumulator from ``acc_save`` output (either package's)
    on ``device`` (default: the card). Checkpoints written before the
    split-slot fields load with empty slots — finalize then reports the
    model σ only until fresh updates populate them. Two-slot-era
    checkpoints load their slot A (even-parity chunks) with B and C
    empty; slot D = total − A is then the odd half, and finalize's K=2
    rung reproduces the estimator they were written under."""
    dev = default_device() if device is None else torch.device(device)
    with np.load(path) as z:
        def cross(s):
            if "cross_re" + s not in z.files:
                return torch.zeros(z["cross_re"].shape, dtype=torch.complex64,
                                   device=dev)
            return torch.complex(
                torch.from_numpy(z["cross_re" + s].astype(np.float32)),
                torch.from_numpy(z["cross_im" + s].astype(np.float32)),
            ).to(dev)

        def count(k):
            return int(z[k]) if k in z.files else 0

        return AccState(
            cross=cross(""),
            psd=torch.from_numpy(z["psd"].astype(np.float32)).to(dev),
            energy=torch.from_numpy(z["energy"].astype(np.float32)).to(dev),
            n_seg=count("n_seg"),
            cross_a=cross("_a"), n_seg_a=count("n_seg_a"),
            n_chunks=count("n_chunks"),
            cross_b=cross("_b"), n_seg_b=count("n_seg_b"),
            cross_c=cross("_c"), n_seg_c=count("n_seg_c"),
        )


def acc_finalize(
    state: AccState,
    pair_idx,
    max_lag: int,
    weighting: str = "ht",
    eps: float = 1e-3,
    fft_len: Optional[int] = None,
) -> CorrResult:
    """Current delay estimates from the accumulated spectra (the state
    is untouched — keep integrating afterwards).

    ``delay_std`` carries a split-slot empirical floor on the batch
    path's estimator ladder (``ops.corr._combine_splits``): once all
    FOUR interleaved slots hold comparable data (≥2 segments each — the
    batch ``split_k`` floor — and a max/min segment ratio ≤2) the four
    slot zoom delays give the 3-dof σ with the K=4 scale; with only the
    even/odd halves populated (2-3 updates, or a two-slot-era
    checkpoint) the K=2 half-split σ; with one slot in all (a single
    update, or a pre-split checkpoint) the model σ stands alone. Only
    the active rung's probes run. Every probe is weighted leave-one-out:
    the OTHER slots' cross-spectrum with the FULL state's PSD (per-slot
    PSDs are not kept, and the selection bias lives in the cross phase,
    which the leave-one-out cross removes)."""
    if fft_len is None:
        fft_len = int(state.cross.shape[-1])
    res = _finish_correlation(
        state.cross, state.psd, state.energy, pair_idx, max_lag, weighting,
        eps, fft_len, "phase", n_seg=state.n_seg)
    if weighting == "none":
        return res
    na, nb, nc = state.n_seg_a, state.n_seg_b, state.n_seg_c
    nd = state.n_seg - na - nb - nc
    counts = (na, nb, nc, nd)
    # K=4 needs every slot at the batch ladder's 2-segment floor
    # (1-segment probes jitter ~0.5 sample even on clean signals) and
    # balanced slots: the scale constant assumes comparable groups, and
    # resumed two-slot-era checkpoints start lopsided.
    valid4 = min(counts) >= 2 and max(counts) <= 2 * min(counts)
    valid2 = na + nc > 0 and nb + nd > 0
    if not (valid4 or valid2):
        return res
    coarse = torch.round(res.delay)
    ca, cb, cc = state.cross_a, state.cross_b, state.cross_c
    cd = state.cross - ca - cb - cc
    m = int(state.cross.shape[0])

    def loo_w(ck, nk):
        return _weight_factor(state.cross - ck, state.psd, pair_idx,
                              weighting, eps, state.n_seg - nk)

    if valid4:
        from tdoa_tpu_torch.ops.kernels.zoom_probe import (
            loo_zoom_delays,
            zoom_probe_supported,
        )

        if zoom_probe_supported(fft_len, max_lag, weighting):
            # Kernel 2 sums the other banks' cross and PSD itself: four
            # PSD banks of psd/3 make its leave-one-out PSD the full
            # state's, which is this rung's weighting.
            n_loo = torch.tensor(
                np.repeat(state.n_seg - np.asarray(counts), m),
                dtype=torch.float32, device=coarse.device)
            ds = loo_zoom_delays(
                torch.stack([ca, cb, cc, cd]),
                (state.psd / 3.0).expand(4, -1, -1).contiguous(),
                pair_idx, coarse, n_loo, eps)
        else:
            ds = torch.stack([
                _zoom_corr_delay(s * loo_w(s, nk), coarse, fft_len, max_lag)
                for s, nk in zip((ca, cb, cc, cd), counts)
            ])
        var4 = ((ds - ds.mean(0)) ** 2).sum(0) / 3.0
        sigma_emp = _SPLIT_STD_SCALE[4] * torch.sqrt(var4 / 4.0)
    else:
        # Even (A+C) vs odd (B+D) chunks, each half weighted by the
        # other: what a two-slot-era checkpoint resumes into.
        h_a, h_b = ca + cc, cb + cd
        sigma_emp = _split_half_sigma(
            h_a, h_b, loo_w(h_a, na + nc), loo_w(h_b, nb + nd),
            coarse, fft_len, max_lag)
    return res._replace(delay_std=torch.maximum(res.delay_std, sigma_emp))


@dataclasses.dataclass
class Track:
    """Smoothed target track in the network's ENU frame: Kalman
    position blend when the windows carry calibrated covariances,
    alpha-beta otherwise."""

    pos_enu: np.ndarray  # [3]
    vel_enu: np.ndarray  # [3] m/s
    last_t: float
    n_updates: int = 1
    quality: float = 0.0
    # Innovation-gate state: EMA of accepted horizontal innovation
    # magnitudes, consecutive coasted (rejected) windows, and the
    # lifetime rejection count.
    innov_ema_m: float = 0.0
    coasts: int = 0
    n_rejected: int = 0
    # Horizontal (E,N) position covariance of the track estimate —
    # maintained only when window fixes arrive with their own
    # calibrated covariance (TargetTracker.update covs_en).
    cov_p: Optional[np.ndarray] = None  # [2, 2]

    def lla(self, origin_lla: np.ndarray) -> np.ndarray:
        return enu_to_lla(self.pos_enu, origin_lla)

    def to_jsonable(self) -> dict:
        """JSON-safe snapshot (checkpoint/resume — see
        ``TargetTracker.state_dict``)."""
        return {
            "pos_enu": [float(v) for v in self.pos_enu],
            "vel_enu": [float(v) for v in self.vel_enu],
            "last_t": float(self.last_t),
            "n_updates": int(self.n_updates),
            "quality": float(self.quality),
            "innov_ema_m": float(self.innov_ema_m),
            "coasts": int(self.coasts),
            "n_rejected": int(self.n_rejected),
            "cov_p": None if self.cov_p is None
            else [[float(v) for v in row] for row in self.cov_p],
        }

    @classmethod
    def from_jsonable(cls, d: dict) -> "Track":
        pos = np.asarray(d["pos_enu"], np.float64)
        vel = np.asarray(d["vel_enu"], np.float64)
        cov = (None if d.get("cov_p") is None
               else np.asarray(d["cov_p"], np.float64))
        # A corrupted-but-parseable state (truncated vector, NaN from a
        # poisoned run, future schema) must fail HERE, inside the
        # loader's try, not at the first window's update.
        if pos.shape != (3,) or vel.shape != (3,):
            raise ValueError(f"track state has shapes {pos.shape}/"
                             f"{vel.shape}, want (3,)/(3,)")
        if not (np.all(np.isfinite(pos)) and np.all(np.isfinite(vel))
                and np.isfinite(float(d["last_t"]))
                and np.isfinite(float(d.get("innov_ema_m", 0.0)))):
            raise ValueError("track state has non-finite fields")
        if cov is not None and (
                cov.shape != (2, 2) or not np.all(np.isfinite(cov))):
            raise ValueError("track state has invalid cov_p")
        return cls(
            pos_enu=pos,
            vel_enu=vel,
            last_t=float(d["last_t"]),
            n_updates=int(d.get("n_updates", 1)),
            quality=float(d.get("quality", 0.0)),
            innov_ema_m=float(d.get("innov_ema_m", 0.0)),
            coasts=int(d.get("coasts", 0)),
            n_rejected=int(d.get("n_rejected", 0)),
            cov_p=cov,
        )


class TargetTracker:
    """Continuous multi-target tracking from per-window TDOA sets.

    Each call to ``update`` takes one processing window's TDOAs per
    target (seconds, pair-ordered), solves each target (float32 LM, on
    ``device``: ``solve_tdoa_enu``), and folds the fixes into the
    tracks.
    """

    def __init__(
        self,
        station_lla: np.ndarray,
        alpha: float = 0.5,
        beta: float = 0.1,
        solve_z: bool = False,
        innovation_gate: bool = True,
        gate_floor_m: float = 500.0,
        gate_k: float = 8.0,
        max_coasts: int = 3,
        process_sigma_v: float = 15.0,  # m/s: Kalman process noise
        device="cpu",
    ):
        self.station_lla = np.asarray(station_lla, dtype=np.float64)
        self.origin = network_origin(self.station_lla)
        self.enu = torch.as_tensor(
            lla_to_enu(self.station_lla, self.origin), dtype=torch.float32
        )
        self.pairs = torch.as_tensor(station_pairs(len(station_lla)))
        self.alpha = alpha
        self.beta = beta
        self.solve_z = solve_z
        # Innovation gate: an established track rejects a measurement
        # landing far outside its own innovation history — one
        # corrupted window (co-channel burst, bad association) must not
        # yank the track. Rejected windows coast on the motion model;
        # after ``max_coasts`` consecutive rejections the measurement
        # is accepted again (the target genuinely moved — re-acquire).
        # ``innovation_gate=False`` or ``max_coasts <= 0`` disables the
        # gate entirely (plain alpha-beta on every window).
        self.innovation_gate = innovation_gate
        self.gate_floor_m = gate_floor_m
        self.gate_k = gate_k
        self.max_coasts = max_coasts
        # Unmodeled-maneuver growth for the Kalman blend: the track
        # covariance inflates by (process_sigma_v·dt)² per axis each
        # window, so a long gap or a turning emitter re-opens the gain.
        self.process_sigma_v = process_sigma_v
        self.device = device
        self.tracks: Dict[str, Track] = {}

    def _solve_batch(self, rd: np.ndarray, w: np.ndarray) -> np.ndarray:
        """Positions [k, 3] of ``k`` targets' range differences ``rd``
        [k, m] under weights ``w`` [k, m]: one float32 LM solve per
        target on the tracker's device, in a loop (a window carries a
        few targets; the solver batches over starts, not over
        targets)."""
        return np.stack([
            solve_tdoa_enu(
                self.enu, self.pairs,
                torch.as_tensor(rd_k, dtype=torch.float32),
                weights=torch.as_tensor(w_k, dtype=torch.float32),
                solve_z=self.solve_z, device=self.device,
            )[0].numpy().astype(np.float64)
            for rd_k, w_k in zip(rd, w)
        ])

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of every track — the tracking
        layer's checkpoint (the stream CLI's ``--state``). The ENU
        frame is defined by the station set, so a state is only
        meaningful for the same ``station_lla`` it was saved under."""
        return {tid: tr.to_jsonable() for tid, tr in self.tracks.items()}

    def load_state_dict(self, d: dict) -> None:
        """Resume tracks saved by ``state_dict`` (replaces any current
        track with the same id)."""
        for tid, s in d.items():
            self.tracks[str(tid)] = Track.from_jsonable(s)

    def update(
        self,
        t: float,
        tdoas_s: Dict[str, np.ndarray],  # target id -> [m] seconds
        qualities: Optional[Dict[str, float]] = None,
        fdoa_hz: Optional[Dict[str, np.ndarray]] = None,  # per-pair Doppler
        carrier_hz: Optional[float] = None,
        velocity_enu: Optional[Dict[str, np.ndarray]] = None,
        weights: Optional[Dict[str, np.ndarray]] = None,  # per-pair
        positions_enu: Optional[Dict[str, np.ndarray]] = None,
        covs_en: Optional[Dict[str, np.ndarray]] = None,  # [2,2] per tid
    ) -> Dict[str, Track]:
        """``fdoa_hz`` (CAF differential Dopplers, ops/caf.py sign
        convention) upgrades the track's velocity from differentiated
        positions to an instantaneous FDOA least-squares measurement
        (solve/fdoa.py) — one window is enough to know the velocity.
        ``velocity_enu`` passes an already-solved velocity measurement
        directly (e.g. the processor's weighted per-emitter solve) and
        takes precedence over re-solving from ``fdoa_hz``.
        ``weights`` carries the processor's final per-pair solve
        weights (``TDOAResult.solve_weights``) — without them the
        tracker's own re-solve would let pairs the processor gated or
        excluded (outlier stations) vote again.
        ``positions_enu`` (per target, in THIS tracker's origin frame)
        bypasses the tracker's own re-solve for those targets: the
        processor's fix already went through the full defense ladder
        (ghost disambiguation by prior/FDOA/power, outlier exclusion) —
        a raw re-solve here can land in the ghost basin the processor
        rejected. Targets without an entry keep the re-solve path.
        ``covs_en`` (per target, horizontal 2×2 ENU covariance of the
        window fix — ``FixResult.cov_en``) upgrades the position blend
        from the fixed-α filter to a Kalman gain: the track keeps its
        own covariance, each window is weighted by how much it actually
        knows (the covariances are chi²-calibrated — see
        scripts/ellipse_calibration.py), and a weak window moves the
        track less instead of α of the way. Targets without an entry
        keep the α-β blend."""
        if not tdoas_s:
            return self.tracks
        ids = list(tdoas_s.keys())
        if positions_enu and all(
                positions_enu.get(i) is not None for i in ids):
            # Every target already carries the processor's fix (the
            # stream CLI's normal case) — skip the batched re-solve
            # entirely instead of computing and discarding it.
            pos = np.stack([
                np.asarray(positions_enu[i], np.float64) for i in ids
            ])
        else:
            rd = np.stack([
                np.asarray(tdoas_s[i]) * SPEED_OF_LIGHT for i in ids
            ])
            ones = np.ones(int(self.pairs.shape[0]))
            w_rows = np.stack([
                ones if weights is None or weights.get(i) is None
                else np.asarray(weights[i], np.float64)
                for i in ids
            ])
            pos = self._solve_batch(rd, w_rows)
            if positions_enu:
                for k, tid in enumerate(ids):
                    if positions_enu.get(tid) is not None:
                        pos[k] = np.asarray(positions_enu[tid], np.float64)
        st_enu = np.asarray(self.enu, np.float64)
        pairs_np = np.asarray(self.pairs)
        def valid_cov(tid):
            r = covs_en.get(tid) if covs_en else None
            if r is None:
                return None
            r = np.asarray(r, np.float64)
            if r.shape != (2, 2) or not np.all(np.isfinite(r)):
                return None
            r = 0.5 * (r + r.T)
            # 2x2 PSD check: positive diagonal + non-negative det.
            if r[0, 0] <= 0 or r[1, 1] <= 0 or np.linalg.det(r) < 0:
                return None
            return r

        for k, tid in enumerate(ids):
            q = float(qualities.get(tid, 0.0)) if qualities else 0.0
            meas = pos[k]
            R = valid_cov(tid)
            v_meas = None
            if velocity_enu is not None and tid in velocity_enu:
                v_meas = np.asarray(velocity_enu[tid], np.float64)
            elif fdoa_hz is not None and tid in fdoa_hz and carrier_hz:
                from tdoa_tpu_torch.solve.fdoa import solve_velocity_enu

                v_meas = solve_velocity_enu(
                    st_enu, pairs_np, meas, fdoa_hz[tid], carrier_hz,
                    solve_z=self.solve_z,
                ).vel_enu
            tr = self.tracks.get(tid)
            if tr is None:
                self.tracks[tid] = Track(
                    pos_enu=meas,
                    vel_enu=v_meas if v_meas is not None else np.zeros(3),
                    last_t=t,
                    quality=q,
                    cov_p=None if R is None else R.copy(),
                )
                continue
            dt = max(t - tr.last_t, 1e-6)
            pred = tr.pos_enu + tr.vel_enu * dt
            resid = meas - pred
            innov = float(np.linalg.norm(resid[:2]))
            # Covariance predict (Kalman blend only): unmodeled
            # maneuvers grow the track's uncertainty with time.
            q_proc = (self.process_sigma_v * dt) ** 2
            cov_pred = (
                None if tr.cov_p is None
                else tr.cov_p + q_proc * np.eye(2)
            )
            # The prediction's own uncertainty widens the gate: after a
            # long gap (service restart from --state, missed windows)
            # the extrapolated position is not trustworthy, and a
            # genuine window landing far from it must be ACCEPTED, not
            # rejected for max_coasts windows of stale extrapolation.
            # For ordinary window spacings the slack (3·σv·dt) sits
            # below the 500 m floor and changes nothing.
            slack = self.process_sigma_v * dt
            if cov_pred is not None:
                slack = max(slack, float(np.sqrt(max(
                    np.linalg.eigvalsh(cov_pred)[-1], 0.0))))
            gate_m = max(self.gate_floor_m,
                         self.gate_k * tr.innov_ema_m) + 3.0 * slack
            if (self.innovation_gate and self.max_coasts > 0
                    and tr.n_updates >= 3
                    and tr.coasts < self.max_coasts
                    and innov > gate_m):
                # A measurement this far outside the track's own
                # innovation history is a corrupted window, not motion:
                # coast on the model and count the miss. max_coasts
                # consecutive rejections mean the target genuinely
                # relocated — the gate then stands down and the next
                # measurement re-acquires.
                tr.pos_enu = pred
                if cov_pred is not None:
                    # Coasting keeps the grown prediction covariance so
                    # the Kalman gain re-opens after the outage.
                    tr.cov_p = cov_pred
                tr.last_t = t
                tr.coasts += 1
                tr.n_rejected += 1
                continue
            if 0 < self.max_coasts <= tr.coasts:
                # Re-acquisition: the target persistently measures
                # elsewhere, so the old state is stale — snap to the
                # measurement instead of alpha-blending toward it over
                # many windows, and restart the track's life: n_updates
                # goes back to 1 (counted since acquisition), which
                # stands the gate down for the next two windows and
                # re-seeds the innovation EMA from them. Without the
                # restart, a moving target re-acquires into a zeroed
                # EMA whose gate then rejects every genuine window — an
                # endless reject/snap limp cycle.
                tr.pos_enu = meas
                tr.vel_enu = (
                    v_meas if v_meas is not None else np.zeros(3)
                )
                tr.innov_ema_m = 0.0
                tr.n_updates = 0
                # The old covariance described the stale state; restart
                # it from the acquiring window's own uncertainty.
                tr.cov_p = None if R is None else R.copy()
            else:
                pos_corr = None  # actual position correction (Kalman)
                if cov_pred is None and R is not None:
                    # First calibrated window on a legacy track: seed
                    # the covariance so the next window runs the true
                    # Kalman blend. (This window itself still alpha-
                    # blends — there is no prior P to weigh against.)
                    tr.cov_p = R.copy()
                if cov_pred is not None and R is not None:
                    # Kalman position update in the horizontal plane:
                    # S = P + R, K = P S⁻¹ — a weak window (large R)
                    # moves the track by almost nothing, a tight one by
                    # almost the full residual, instead of a fixed α.
                    gain = cov_pred @ np.linalg.inv(cov_pred + R)
                    tr.pos_enu = pred.copy()
                    tr.pos_enu[:2] = pred[:2] + gain @ resid[:2]
                    # No calibrated vertical covariance exists; z keeps
                    # the α blend.
                    tr.pos_enu[2] = pred[2] + self.alpha * resid[2]
                    pos_corr = tr.pos_enu - pred
                    new_p = (np.eye(2) - gain) @ cov_pred
                    tr.cov_p = 0.5 * (new_p + new_p.T)
                else:
                    if cov_pred is not None:
                        # Un-calibrated window on a Kalman track: the α
                        # blend ran, keep the grown prediction
                        # covariance alive for the next window.
                        tr.cov_p = cov_pred
                    tr.pos_enu = pred + self.alpha * resid
                if v_meas is not None:
                    # Direct velocity measurement: blend instead of the
                    # beta/dt differentiation (which only corrects
                    # velocity via position residuals, windows late).
                    tr.vel_enu = (
                        (1.0 - self.alpha) * tr.vel_enu
                        + self.alpha * v_meas
                    )
                elif pos_corr is not None:
                    # Differentiated velocity must follow the position
                    # correction the gain ACTUALLY applied (legacy
                    # relation: vel-corr = β/(α·dt) × pos-corr) — a
                    # weak window that barely moved the position must
                    # not yank the velocity either.
                    tr.vel_enu = tr.vel_enu + (
                        self.beta / (self.alpha * dt)
                    ) * pos_corr
                else:
                    tr.vel_enu = tr.vel_enu + (self.beta / dt) * resid
                tr.innov_ema_m = (
                    innov if tr.n_updates < 2
                    else 0.7 * tr.innov_ema_m + 0.3 * innov
                )
            tr.coasts = 0
            tr.last_t = t
            tr.n_updates += 1
            tr.quality = q
        return self.tracks
