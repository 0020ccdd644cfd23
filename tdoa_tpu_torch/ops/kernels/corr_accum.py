"""Kernel 1: segment FFT + cross-spectra + banked accumulation.

Replaces ``tdoa_tpu/ops/pallas/corr_accum.py`` (``_kernel`` via
``accumulate_cross_spectra_pallas``). Each 45056-sample segment of
every station is zero-padded to 65536 and transformed; over the
segments of each of ``n_splits`` contiguous banks (bounded exactly like
``ops.corr._split_bounds``) the kernel accumulates per-pair
cross-spectra ``X_j·conj(X_i)``, per-station PSD ``|X|²`` and, for DC
removal, per-station spectral sums ``ΣX`` — all in TRUE frequency
order. ``_finalize_banks`` then folds in the DC removal
(``FFT(x−m) = FFT(x) − m·D``) and the optional unit-RMS prescale.

The CUDA kernel (``csrc/corr_accum.cu``) computes the transform in its
own body (four-step 256×256 with 16×16 register FFTs, f32 arithmetic on
bf16 or f32 input) in two launches: stage 1 writes the four-step
hand-off of the whole block to one scratch in HBM (``scratch_bytes``;
``slot_plan`` lays out the banks' segments in it), and stage 2 gives
each CTA one (bank, row) item at a time, whose accumulators (``n_slots``
rows of 256 f32) stay in shared memory while the bank's segments stream
past and reach the outputs once.
``accumulate_banks`` is the wrapper: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes ``accumulate_banks_plain``, the same
sums with ``torch.fft`` — also what the kernel is held against on the
card.

Pair tiling (the counterpart of the reference's pair chunks,
``tdoa_tpu/ops/pallas/corr_accum.py:497-538``): a stage-2 CTA
holds one item's accumulators in shared memory, so from 13 stations
(all pairs, DC sums) no launch holds the whole pair list.
``plan_tiles`` sizes tiles by the kernel's own footprint formula
(``smem_bytes``, a mirror of ``csrc/corr_accum.cu``) against the card's
opt-in limit, and ``accumulate_banks`` launches once per tile and
stitches the cross banks along the pair axis. Every sum in the kernel
runs in segment order, per pair and per station alone, so a tiled
result is bitwise the untiled one.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

R = 256  # radix: FFT_LEN = R*R
SEG_ROWS = 176  # data rows per segment; the other 80 rows are zero padding
FFT_LEN = R * R  # 65536
SEG_LEN = SEG_ROWS * R  # 45056

# The segments of the longest block a capture holds (a 100 s window in
# three blocks): the overlapped ingest's gate (``fits_device``) counts
# the kernel's scratch, which grows with the chunk, at this length, so
# that one verdict holds for every chunk of a process; the batch route
# counts it at the block's own length.
MAX_BLOCK_SEGS = 1480
# The kernel's transform-buffer constants (csrc/corr_accum.cu: GROUPS,
# SLOT), for the footprint mirror below.
_GROUPS = 16
_SLOT = 16 * 17 + 1


def n_slots(n_st: int, m: int, track: bool) -> int:
    """Accumulator rows of one (bank, row) item: cross re/im for each
    pair, PSD per station, and with ``track`` the sums' re/im
    (``n_slots`` in ``csrc/corr_accum.cu``)."""
    return 2 * m + n_st * (3 if track else 1)


def smem_bytes(n_st: int, m: int, track: bool) -> int:
    """Shared memory of a stage-2 CTA, which holds one item's
    accumulators: the twiddle tables, the transform buffers and their
    flags, the pair list and the accumulators — the kernel's own formula
    (``smem_bytes`` in ``csrc/corr_accum.cu``), mirrored here for the
    tile planner; ``launch_bytes`` holds the mirror and the library to
    each other."""
    def pad4(n):
        return (n + 3) & ~3

    xs = max(n_st, _GROUPS)
    return (3 * R * 8 + xs * _SLOT * 8 + 4 * pad4(xs) + 4 * pad4(2 * m)
            + n_slots(n_st, m, track) * R * 4)


def max_tile_pairs(n_st: int, track: bool, optin: int) -> int:
    """The most pairs one launch over ``n_st`` rows holds: one item's
    accumulators (a stage-2 CTA's) within ``optin`` bytes of
    shared memory; 0 where the per-station rows alone exceed it. On the
    H100 (232,448 B opt-in) that is all 66 pairs of 12 stations with DC
    sums (213,712 B), 60 at 16 stations, 46 at 24."""
    room = optin - smem_bytes(n_st, 0, track)
    m = max(room // (2 * R * 4 + 8), 0)  # 2 rows and 2 indices a pair
    while m > 0 and smem_bytes(n_st, m, track) > optin:
        m -= 1
    return m


def scratch_bytes(n_st: int, n_banks: int, n_seg: int) -> int:
    """Device bytes of a launch's scratch: stage 1's 512 KB spectrum of
    every station and segment slot (``slot_plan``: each bank as long as
    the longest)."""
    return n_st * n_banks * -(-n_seg // n_banks) * FFT_LEN * 8


@functools.lru_cache(maxsize=8)
def smem_optin(device) -> int:
    """The opt-in shared memory a block may use on CUDA ``device``."""
    return int(torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin)


def plan_tiles(pairs, n_st: int, track: bool, optin=None,
               max_pairs=None) -> tuple:
    """The kernel launches that accumulate ``pairs`` over ``n_st``
    rows: a tuple of ``(r0, r1, lo, hi)``, each launch running on rows
    ``r0:r1`` for ``pairs[lo:hi]``, in pair order.

    One launch where it holds every pair (``max_tile_pairs`` against
    ``optin`` bytes; no limit when both it and ``max_pairs`` are None, as
    for the plain version on the CPU). Else the pair list splits first
    where it falls into blocks of rows that share no pair (the stacked
    3·n_st rows of the overlapped ingest: one block each), then each
    block's pairs into near-equal tiles (q or q+1 pairs, as the
    reference's chunks) at the block's own capacity, or at
    ``max_pairs`` (the counterpart of the reference's
    ``_force_max_pairs``, for tests). A block's first tile carries its
    rows' PSD and sums. Raises ``ValueError`` where one pair does not
    fit a launch."""
    p = np.asarray(pairs, np.int64).reshape(-1, 2)
    m = len(p)

    def cap(rows):
        if max_pairs is not None:
            return int(max_pairs)
        if optin is None:
            return m
        return max_tile_pairs(rows, track, optin)

    if m <= cap(n_st):
        return ((0, n_st, 0, m),)
    lo_row, hi_row = p.min(1), p.max(1)
    # Split before pair k where every earlier pair lies below every later.
    before = np.maximum.accumulate(hi_row)[:-1]
    after = np.minimum.accumulate(lo_row[::-1])[::-1][1:]
    cuts = [0, *(np.nonzero(before < after)[0] + 1).tolist(), m]
    rows = [0, *(int(lo_row[k:].min()) for k in cuts[1:-1]), n_st]
    tiles = []
    for g in range(len(cuts) - 1):
        r0, r1 = rows[g], rows[g + 1]
        c = cap(r1 - r0)
        if c < 1:
            raise ValueError(
                f"corr_accum: no launch holds one pair over {r1 - r0} rows "
                f"(per-station accumulators alone exceed the shared memory)")
        m_g = cuts[g + 1] - cuts[g]
        n_t = -(-m_g // c)
        q, r = divmod(m_g, n_t)
        lo = cuts[g]
        for t in range(n_t):
            hi = lo + q + (1 if t < r else 0)
            tiles.append((r0, r1, lo, hi))
            lo = hi
    return tuple(tiles)


@functools.lru_cache(maxsize=None)
def _dc_window_np() -> np.ndarray:
    d = np.fft.fft(np.ones(SEG_LEN), FFT_LEN)
    return d.astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _dc_window(device) -> torch.Tensor:
    """FFT of the segment's rectangular window (SEG_LEN ones, zero-padded
    to FFT_LEN), true frequency order, complex64 on ``device``; copied
    there once per process, like ``device_pairs``."""
    return torch.from_numpy(_dc_window_np()).to(device)


def bank_bounds(n_seg: int, n_banks: int) -> list:
    """Segment-index bounds of the banks: the first ``n_seg % n_banks``
    banks hold one segment more (``ops.corr._split_bounds`` in units of
    segments)."""
    q, r = divmod(n_seg, n_banks)
    b = [0]
    for k in range(n_banks):
        b.append(b[-1] + q + (1 if k < r else 0))
    return b


def pairs_key(pairs: Sequence[Tuple[int, int]]) -> tuple:
    """``pairs`` as a tuple of (i, j) int tuples: hashable, and cheap to
    check on every launch."""
    return tuple((int(i), int(j))
                 for i, j in np.reshape(pairs, (-1, 2)).tolist())


def device_pairs(pairs: Sequence[Tuple[int, int]], device) -> torch.Tensor:
    """``pairs`` as int32 [m, 2] on ``device``, copied there once per
    process (a host→card copy from pageable memory waits for the card,
    which would stall the stream before every launch)."""
    return _device_pairs(pairs_key(pairs), torch.device(device))


@functools.lru_cache(maxsize=64)
def _device_pairs(key, device) -> torch.Tensor:
    return torch.tensor(key, dtype=torch.int32, device=device).reshape(-1, 2)


@functools.lru_cache(maxsize=64)
def _device_floats(key, device) -> torch.Tensor:
    return torch.tensor(key, dtype=torch.float32, device=device)


def _check_input(x: torch.Tensor, pairs) -> Tuple[int, int, int]:
    if x.dim() != 3 or x.shape[0] != 2:
        raise ValueError(f"x must be planar [2, n_st, N], got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    n_st, n = int(x.shape[1]), int(x.shape[2])
    p = np.asarray(pairs).reshape(-1, 2)
    if p.size == 0 or p.min() < 0 or p.max() >= n_st:
        raise ValueError(f"pairs {pairs!r} invalid for {n_st} stations")
    n_seg = n // SEG_LEN
    if n_seg == 0:
        raise ValueError(
            f"capture length {n} is shorter than one kernel segment "
            f"(SEG_LEN={SEG_LEN}); short captures take the segmented "
            f"path (ops.corr.correlate_pairs_planar)")
    return n_st, n_seg, len(p)


def accumulate_banks_plain(x: torch.Tensor, pairs, n_banks: int,
                            track_sums: bool, chunk: int = 16):
    """Plain torch version of the kernel: same banks, same sums, with
    ``torch.fft`` on complex64. Returns (cross c64 [K, m, F], psd f32
    [K, n_st, F], sums c64 [K, n_st, F] or None)."""
    n_st, n_seg, m = _check_input(x, pairs)
    p = np.asarray(pairs, np.int64).reshape(-1, 2)
    dev = x.device
    ii = torch.from_numpy(p[:, 0]).to(dev)
    jj = torch.from_numpy(p[:, 1]).to(dev)
    cross = torch.zeros(n_banks, m, FFT_LEN, dtype=torch.complex64, device=dev)
    psd = torch.zeros(n_banks, n_st, FFT_LEN, dtype=torch.float32, device=dev)
    sums = (torch.zeros(n_banks, n_st, FFT_LEN, dtype=torch.complex64,
                        device=dev) if track_sums else None)
    bounds = bank_bounds(n_seg, n_banks)
    for b in range(n_banks):
        for s0 in range(bounds[b], bounds[b + 1], chunk):
            s1 = min(s0 + chunk, bounds[b + 1])
            seg = x[:, :, s0 * SEG_LEN:s1 * SEG_LEN].to(torch.float32)
            z = torch.complex(seg[0], seg[1]).reshape(n_st, s1 - s0, SEG_LEN)
            spec = torch.fft.fft(z, n=FFT_LEN, dim=-1)  # [n_st, S, F]
            psd[b] += (spec.real.square() + spec.imag.square()).sum(1)
            if track_sums:
                sums[b] += spec.sum(1)
            cross[b] += (spec[jj] * spec[ii].conj()).sum(1)
    return cross, psd, sums


def slot_plan(n_seg: int, n_banks: int) -> np.ndarray:
    """The kernel's segment slots: int32 [n_banks·run], ``run`` the
    longest bank's segments; bank k (``bank_bounds``) lists its segments
    in order from slot k·run, −1 past its end."""
    b = bank_bounds(n_seg, n_banks)
    run = -(-n_seg // n_banks)
    plan = np.full((n_banks, run), -1, np.int32)
    for k in range(n_banks):
        plan[k, :b[k + 1] - b[k]] = np.arange(b[k], b[k + 1])
    return plan.reshape(-1)


def _launch_shape(n_st, m, track_sums, bf16, device):
    """(CUDA error, shape) of the kernel's launch on ``device``, as the
    built library chooses it (once per device and shape): stage 2's
    grid, its CTAs per SM and shared memory per CTA, and stage 1's
    grid."""
    from tdoa_tpu_torch.ops.kernels import _build

    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = _build.load().tdoa_corr_accum_config(
            n_st, m, int(track_sums), int(bf16), out)
    return err, dict(zip(("grid", "blocks_per_sm", "smem_bytes",
                          "stage1_grid"), (int(x) for x in out)))


def kernel_config(n_st: int, pairs, track_sums: bool, bf16: bool = True,
                  device=None) -> dict:
    """The launches the kernel takes on ``device`` (default: the current
    card) for ``pairs`` over ``n_st`` rows, as ``accumulate_banks`` runs
    them (the tiles of ``plan_tiles``): the launch of the largest tile —
    stage 2's grid, its CTAs per SM and shared memory per CTA, and stage
    1's grid — with ``tiles`` (launches), ``rows`` and ``m_tile`` (the
    largest tile's rows and pairs)."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    tiles = _tiles(pairs_key(pairs), n_st, track_sums, smem_optin(dev), None)
    rows, m_tile = max(_launch_shapes(tiles),
                       key=lambda s: smem_bytes(*s, track_sums))
    err, cfg = _launch_shape(rows, m_tile, track_sums, bf16, dev)
    if err != 0:
        raise RuntimeError(f"corr_accum has no launch for {rows} rows, "
                           f"{m_tile} pairs: CUDA error {err}")
    return {**cfg, "tiles": len(tiles), "rows": rows, "m_tile": m_tile}


def _launch_shapes(tiles) -> list:
    """The distinct (rows, pairs) of a tile plan's launches."""
    return sorted({(r1 - r0, hi - lo) for r0, r1, lo, hi in tiles})


@functools.lru_cache(maxsize=64)
def _device_plan(n_seg: int, n_banks: int, device) -> torch.Tensor:
    return torch.from_numpy(slot_plan(n_seg, n_banks)).to(device)


def launch_bytes(n_st: int, pairs, track_sums: bool, n_banks: int,
                 device: torch.device, n_seg: int):
    """Device bytes the kernel needs to run ``pairs`` over ``n_st`` rows
    of ``n_seg`` segments in ``n_banks`` banks on ``device``, as
    ``accumulate_banks`` launches them (the tiles of ``plan_tiles`` at
    the device's opt-in shared memory): the largest launch's scratch
    (``scratch_bytes``, which grows with the block), the bank
    accumulators and, where the list is tiled, the tiles' outputs beside
    them. None where no launch holds one pair. Every tile's launch must
    have a shape: the footprint mirror plans them, and where the built
    library refuses one this raises."""
    key = pairs_key(pairs)
    optin = smem_optin(device)
    try:
        tiles = _tiles(key, n_st, track_sums, optin, None)
    except ValueError:  # no launch holds one pair
        return None
    scratch = 0
    for rows, m_tile in _launch_shapes(tiles):
        err, _ = _launch_shape(rows, m_tile, track_sums, True, device)
        if err != 0:
            raise RuntimeError(
                f"corr_accum launch shape for {rows} rows, {m_tile} pairs: "
                f"CUDA error {err} (the footprint mirror says it fits)")
        scratch = max(scratch, scratch_bytes(rows, n_banks, n_seg))
    acc = n_banks * FFT_LEN * (8 * len(key) + 4 * n_st
                               + (8 * n_st if track_sums else 0))
    return scratch + acc + (acc if len(tiles) > 1 else 0)


def fits_device(n_st: int, pairs, track_sums: bool, n_banks: int,
                device: torch.device) -> bool:
    """Whether the kernel runs ``pairs`` over ``n_st`` rows on
    ``device``: some launch holds the pairs and the device's free
    memory holds ``launch_bytes`` with the scratch counted at
    ``MAX_BLOCK_SEGS``, the longest block a capture holds (the
    overlapped ingest's gate, one verdict for every chunk)."""
    need = launch_bytes(n_st, pairs, track_sums, n_banks, device,
                        MAX_BLOCK_SEGS)
    return need is not None and need < torch.cuda.mem_get_info(device)[0]


def accumulate_banks(x: torch.Tensor, pairs, n_banks: int = 1,
                     track_sums: bool = False, max_pairs=None):
    """Raw banked accumulators of planar ``x`` [2, n_st, N] (bf16 or
    f32; N truncated to whole segments): (cross c64 [K, m, F], psd f32
    [K, n_st, F], sums c64 [K, n_st, F] or None), true frequency order.

    The pair list goes in the tiles of ``plan_tiles`` (on a card: as many
    pairs a launch as its shared memory holds; ``max_pairs`` forces the
    tile size, for tests and the smoke), each tile one call below; the
    cross banks are stitched along the pair axis, PSD and sums taken
    from each row block's first tile. CPU tensors take the plain torch
    version per tile; CUDA tensors launch ``csrc/corr_accum.cu`` per
    tile (a launch that fails raises) and count each launch in
    ``accumulate_banks.launches`` and, by ``(rows, segments, banks,
    pairs)``, in ``accumulate_banks.launch_shapes``. Stage 1 depends on
    the rows alone, so the tiles of one row block after its first reuse
    the first one's hand-off."""
    n_st, _, _ = _check_input(x, pairs)
    key = pairs_key(pairs)
    optin = None if x.device.type == "cpu" else smem_optin(x.device)
    tiles = _tiles(key, n_st, track_sums, optin, max_pairs)
    if len(tiles) == 1:
        return _accumulate_tile(x, key, n_banks, track_sums)[:3]
    cross, psd, sums = [], [], []
    stage1 = None  # the stage-1 hand-off of the current row block
    for t, (r0, r1, lo, hi) in enumerate(tiles):
        sub = tuple((i - r0, j - r0) for i, j in key[lo:hi])
        if t > 0 and r0 != tiles[t - 1][0]:
            stage1 = None
        c, p, s, stage1 = _accumulate_tile(x[:, r0:r1], sub, n_banks,
                                           track_sums, stage1)
        cross.append(c)
        if t == 0 or r0 != tiles[t - 1][0]:  # a row block's first tile
            psd.append(p)
            sums.append(s)
    return (torch.cat(cross, 1), torch.cat(psd, 1),
            torch.cat(sums, 1) if track_sums else None)


@functools.lru_cache(maxsize=64)
def _tiles(key, n_st, track, optin, max_pairs) -> tuple:
    return plan_tiles(key, n_st, track, optin, max_pairs)


def _accumulate_tile(x: torch.Tensor, pairs, n_banks: int,
                     track_sums: bool, stage1=None):
    """One tile: the plain version for a CPU tensor, one call of the
    kernel for a CUDA tensor (or an error): its two launches, stage 1
    skipped where ``stage1`` (an earlier tile's hand-off of the same
    rows, segments and banks) is given. Returns (cross, psd, sums, the
    stage-1 hand-off or None)."""
    if x.device.type == "cpu":
        return (*accumulate_banks_plain(x, pairs, n_banks, track_sums), None)
    from tdoa_tpu_torch.ops.kernels import _build
    from tdoa_tpu_torch.utils.platform import require_sm90

    require_sm90(x.device)
    n_st, n_seg, m = _check_input(x, pairs)
    if x.stride(2) != 1:
        raise ValueError("x must be contiguous along the sample axis")
    if not 1 <= n_banks <= n_seg:
        raise ValueError(f"n_banks {n_banks} outside [1, {n_seg} segments]")
    lib = _build.load()
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    pairs_d = device_pairs(pairs, dev)
    plan = _device_plan(n_seg, n_banks, dev)
    size = scratch_bytes(n_st, n_banks, n_seg) // 4
    reuse = stage1 is not None and stage1.numel() == size
    scratch = stage1 if reuse else torch.empty(size, dtype=torch.float32,
                                               device=dev)
    cross = torch.empty(n_banks, m, FFT_LEN, dtype=torch.complex64, device=dev)
    psd = torch.empty(n_banks, n_st, FFT_LEN, dtype=torch.float32, device=dev)
    sums = (torch.empty(n_banks, n_st, FFT_LEN, dtype=torch.complex64,
                        device=dev) if track_sums else None)
    err = lib.tdoa_corr_accum(
        ctypes.c_void_p(x[0].data_ptr()), ctypes.c_void_p(x[1].data_ptr()),
        int(bf16), int(x.stride(1)), n_st,
        ctypes.c_void_p(pairs_d.data_ptr()), m, n_banks, int(track_sums),
        ctypes.c_void_p(plan.data_ptr()), plan.numel() // n_banks,
        int(reuse), ctypes.c_void_p(scratch.data_ptr()),
        ctypes.c_void_p(cross.data_ptr()), ctypes.c_void_p(psd.data_ptr()),
        ctypes.c_void_p(0 if sums is None else sums.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"corr_accum kernel launch failed: CUDA error {err} "
                           f"({n_st} rows, {m} pairs, {n_banks} banks)")
    accumulate_banks.launches += 1
    accumulate_banks.launch_shapes[(n_st, n_seg, n_banks, m)] += 1
    return cross, psd, sums, scratch


accumulate_banks.launches = 0
accumulate_banks.launch_shapes = collections.Counter()


def _finalize_banks(cross, psd, sums, pairs, seg_g, remove_dc: bool,
                    prescale: bool):
    """Accumulator banks → finalized spectra: the DC-removal algebra and
    (optionally) the deferred unit-RMS prescale, batched over the bank
    axis G. ``seg_g`` is the per-bank segment count. Returns (cross c64
    [G, m, F], psd [G, n_st, F], energy [G, n_st])."""
    dev = cross.device
    # Index and count tensors come from per-process caches: a fresh
    # host→card copy here would make every streamed chunk wait for the
    # card (see ``device_pairs``).
    ii, jj = device_pairs(pairs, dev).long().unbind(1)
    seg_g = _device_floats(tuple(float(s) for s in seg_g), dev)
    use_g = seg_g * SEG_LEN  # [G]
    if remove_dc:
        # Bank mean from the spectral sum's DC bin: Σ_seg X(0) = Σ xₙ.
        mean = sums[:, :, 0] / use_g[:, None]  # [G, n_st] c64
        a = mean[..., None] * _dc_window(torch.device(dev))  # A_st = m_st · D
        aj, ai = a[:, jj], a[:, ii]
        si, sj = sums[:, ii], sums[:, jj]
        ns = seg_g[:, None, None]
        # Σ(Xⱼ−Aⱼ)(Xᵢ−Aᵢ)* = cross − Aⱼ∘S̄ᵢ − Āᵢ∘Sⱼ + n_seg·Aⱼ∘Āᵢ
        cross = cross - aj * si.conj() - ai.conj() * sj + ns * (aj * ai.conj())
        # Σ|X−A|² = psd − 2Re(Ā∘S) + n_seg|A|²; clamp the DC bin's f32
        # cancellation, which can round slightly negative.
        a_re, a_im = a.real, a.imag
        psd = torch.clamp(
            psd - 2.0 * (a_re * sums.real + a_im * sums.imag)
            + ns * (a_re * a_re + a_im * a_im),
            min=0.0,
        )
    # Demeaned per-station power via Parseval: Σₙ|x−m|² = (1/F)Σₖ psd'.
    power_dm = torch.clamp(psd.sum(-1) / FFT_LEN / use_g[:, None], min=1e-30)
    if prescale:
        sc = 1.0 / torch.sqrt(power_dm)  # [G, n_st]
        s_pair = sc[:, ii] * sc[:, jj]
        cross = cross * s_pair[..., None]
        psd = psd * (sc * sc)[..., None]
        energy = use_g[:, None].expand_as(power_dm)
    else:
        energy = power_dm * use_g[:, None]
    return cross, psd, energy


def accumulate_cross_spectra(x: torch.Tensor, pairs, remove_dc: bool = False,
                             prescale: bool = False, n_splits: int = 1):
    """Finalized spectra of planar ``x`` [2, n_st, N]: (cross c64 [m, F],
    psd [n_st, F], energy [n_st]), or with ``n_splits=K > 1`` a leading
    bank axis on each — ``accumulate_cross_spectra_pallas``'s contract.
    ``remove_dc`` subtracts each bank's mean, ``prescale`` normalizes to
    unit RMS (single bank only: per-bank RMS would break the
    banks-sum-to-full invariant)."""
    if n_splits > 1 and prescale:
        raise ValueError("prescale with n_splits > 1 is ill-defined; scale "
                         "the banks by the full capture's RMS in the caller")
    n_seg = int(x.shape[-1]) // SEG_LEN
    if n_splits > max(n_seg, 1):
        raise ValueError(f"n_splits {n_splits} exceeds the segment count "
                         f"{n_seg}")
    cross, psd, sums = accumulate_banks(x, pairs, n_splits, remove_dc)
    b = bank_bounds(n_seg, n_splits)
    seg_g = np.diff(np.asarray(b)).astype(np.float32)
    cross, psd, energy = _finalize_banks(cross, psd, sums, pairs, seg_g,
                                         remove_dc, prescale)
    if n_splits == 1:
        return cross[0], psd[0], energy[0]
    return cross, psd, energy

