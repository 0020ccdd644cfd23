"""Sequence parallelism: shard the capture's time axis over ranks.

Torch port of ``tdoa_tpu.parallel.mesh``. One long capture is split
into contiguous chunks, one per rank: each rank transforms its own
segments and accumulates partial cross-power spectra, ONE sum
all-reduce merges the accumulators (a few MB, independent of the
capture's length), and the cheap tail (GCC weighting, inverse FFT, peak
search, clock correction) runs on every rank, which all return the same
result.

The reference builds a 1-D ``jax.sharding.Mesh`` over the devices of
one controller and runs a ``shard_map`` program with ``psum``. Here a
mesh is one process per rank over ``torch.distributed``
(``parallel/launch.py`` starts them): each process holds its rank, its
device and the process group whose all-reduce stands for the psum.
Every rank calls every function of this module with the same arguments,
as every device of the reference's mesh runs the same program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tdoa_tpu_torch.ops.corr import (
    CorrResult,
    _accumulate_cross_spectra,
    _combine_splits,
    _finish_correlation,
    clock_correct_blocks,
    resolve_seg,
    split_k,
)
from tdoa_tpu_torch.utils.constants import DEFAULT_MAX_LAG
from tdoa_tpu_torch.utils.platform import default_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a 1-D mesh: the process group that reduces
    over it, this process's rank in it, its size, the device this rank
    computes on, and the axis name."""

    group: object  # a torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device
    axis: str = "sp"


def make_mesh(n_devices: Optional[int] = None, axis: str = "sp",
              device=None) -> Optional[Mesh]:
    """A 1-D mesh over the first ``n_devices`` ranks of the default
    process group (default: all of them).

    Every rank of the world must call it: a mesh smaller than the world
    is a new process group, whose creation is collective. Ranks outside
    the mesh get ``None``. The rank's device is its card,
    ``cuda:{rank % device_count}`` (raises when none is visible), unless
    ``device`` says otherwise (``"cpu"``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs torch.distributed's default process group: "
            "start the ranks with tdoa_tpu_torch.parallel.launch.spawn, "
            "or call torch.distributed.init_process_group in each first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices {n_devices} outside [1, {world} ranks]")
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n))))
    if rank >= n:
        return None
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(group=group, rank=rank, size=n, device=dev, axis=axis)


def _chunk_plan(n: int, d: int, max_lag: int, seg_len: Optional[int],
                accumulator: str) -> Tuple[int, int, int]:
    """(samples per rank, segment length, FFT length) for a capture of
    ``n`` samples over ``d`` ranks."""
    per = n // d
    if accumulator == "pallas":
        from tdoa_tpu_torch.ops.kernels.corr_accum import FFT_LEN, SEG_LEN

        if max_lag > FFT_LEN - SEG_LEN:
            raise ValueError(
                f"max_lag {max_lag} exceeds the fused kernel's alias-free "
                f"window {FFT_LEN - SEG_LEN}; use accumulator='xla'")
        per = (per // SEG_LEN) * SEG_LEN
        if per == 0:
            raise ValueError(
                f"per-rank chunk {n // d} is shorter than one kernel "
                f"segment (SEG_LEN={SEG_LEN}); fewer ranks or "
                f"accumulator='xla'")
        return per, SEG_LEN, FFT_LEN
    if accumulator != "xla":
        raise ValueError(f"accumulator must be 'xla' or 'pallas', got "
                         f"{accumulator!r}")
    seg, fft_len = resolve_seg(per, max_lag, seg_len, None)
    return per, seg, fft_len


def _split_groups(n_seg: int, d: int) -> int:
    """The split error bar's groups over ``d`` ranks holding ``n_seg``
    segments in all: ``split_k``'s, halved until the ranks divide into
    that many contiguous groups (the reference's
    ``tdoa_tpu/parallel/mesh.py:165-167``)."""
    K = split_k(n_seg)
    while K > 1 and d % K != 0:
        K //= 2
    return K


def _pair_array(pairs) -> np.ndarray:
    p = np.asarray(pairs, np.int64).reshape(-1, 2)
    if p.size == 0:
        raise ValueError("no pairs to correlate")
    return p


def _reduce_groups(cross, psd, energy, K: int, gid: int, mesh: Mesh):
    """The sum over the mesh of each group's accumulators, stacked
    ``[K, ...]``: this rank's accumulators go into row ``gid`` of one
    flat f32 buffer (the complex cross-spectra as real pairs, so no
    backend's complex support matters), and ONE all-reduce sums it."""
    parts = (torch.view_as_real(cross), psd, energy)
    flat = torch.cat([t.reshape(-1) for t in parts])
    buf = torch.zeros(K, flat.numel(), dtype=torch.float32, device=flat.device)
    buf[gid] = flat
    dist.all_reduce(buf, group=mesh.group)
    out, o = [], 0
    for t in parts:
        out.append(buf[:, o:o + t.numel()].reshape(K, *t.shape))
        o += t.numel()
    return torch.view_as_complex(out[0].contiguous()), out[1], out[2]


def _correlate_chunk(xl: torch.Tensor, p: np.ndarray, mesh: Mesh,
                     max_lag: int, seg: int, fft_len: int, weighting: str,
                     eps: float, refine: str,
                     accumulator: str) -> CorrResult:
    """The sharded program on this rank's chunk ``xl`` [2, n_st, per]
    (f32, on the rank's device)."""
    if accumulator == "pallas":
        from tdoa_tpu_torch.ops.kernels.corr_accum import (
            accumulate_cross_spectra,
        )

        # Kernel 1, one bank, no DC removal, no prescale.
        cross, psd, energy = accumulate_cross_spectra(xl, p)
    else:
        cross, psd, energy = _accumulate_cross_spectra(xl, p, seg, fft_len)
    d = mesh.size
    # The segments behind the summed accumulators: the HT coherence is
    # debiased by this count exactly as on one device.
    n_seg = (int(xl.shape[-1]) // seg) * d
    K = _split_groups(n_seg, d) if refine == "phase" else 0
    if K >= 2:
        # The split error bar: the chunks are contiguous, so the rank
        # groups rank // (d/K) hold the capture's K contiguous slices.
        cross_g, psd_g, energy_g = _reduce_groups(
            cross, psd, energy, K, mesh.rank // (d // K), mesh)
        return _combine_splits(cross_g, psd_g, energy_g, p, max_lag,
                               weighting, eps, fft_len, n_seg)
    cross, psd, energy = (t[0] for t in _reduce_groups(cross, psd, energy,
                                                       1, 0, mesh))
    return _finish_correlation(cross, psd, energy, p, max_lag, weighting,
                               eps, fft_len, refine, n_seg=n_seg)


def correlate_pairs_sharded(
    x: torch.Tensor,  # [2, n_st, N] planar, the whole capture
    pairs,
    mesh: Mesh,
    max_lag: int = DEFAULT_MAX_LAG,
    seg_len: Optional[int] = None,
    weighting: str = "ht",
    eps: float = 1e-3,
    refine: str = "phase",
    accumulator: str = "xla",  # "xla" | "pallas" (kernel 1 per rank)
) -> CorrResult:
    """Sequence-parallel GCC correlation: the time axis of planar ``x``
    sharded over ``mesh``.

    Every rank passes the whole capture (on any device: a host tensor
    stays there) and copies only its chunk ``[r·per, (r+1)·per)`` to
    its device as f32; the capture is truncated to ``per·d`` samples.
    Each rank accumulates its chunk's cross-spectra (``"xla"``: the
    segmented correlator's torch FFTs at ``resolve_seg(per, …)``;
    ``"pallas"``: kernel 1, ``per`` a whole number of its segments), one
    all-reduce merges them, and every rank finishes the same result.
    Equal to the one-device path up to float reassociation where the
    segment boundaries coincide.

    ``pairs`` ([m, 2]) serves as both the reference's ``pair_idx`` and
    its static ``pairs_static``: the kernel's wrapper keeps one device
    copy per pair list (``corr_accum.device_pairs``)."""
    p = _pair_array(pairs)
    per, seg, fft_len = _chunk_plan(int(x.shape[-1]), mesh.size, max_lag,
                                    seg_len, accumulator)
    lo = mesh.rank * per
    xl = x[..., lo:lo + per].to(mesh.device, torch.float32).contiguous()
    return _correlate_chunk(xl, p, mesh, max_lag, seg, fft_len, weighting,
                            eps, refine, accumulator)


def process_blocks_sharded(
    ref1: torch.Tensor,  # [2, n_st, L] planar, the whole block
    tgt: torch.Tensor,
    ref2: torch.Tensor,
    pairs,  # [m, 2]
    ref_geo_tdoa,  # [m] reference-tx geometric TDOA, samples
    mesh: Mesh,
    max_lag: int = DEFAULT_MAX_LAG,
    seg_len: Optional[int] = None,
    weighting: str = "ht",
    clock_correction: bool = True,
    accumulator: str = "xla",  # "xla" | "pallas" (kernel 1 per rank)
):
    """The full sequence-parallel processing step: all 3 blocks × all
    pairs with clock correction; ``pipeline.process_blocks``'s tuple
    (corrected, tgt_delay, ref_delays, clock, quality, peaks,
    corrected_std, tgt_window, tgt_std, block windows complex).

    Every rank passes the whole blocks, as ``correlate_pairs_sharded``
    takes them, and copies only its chunk of each to its device. Each
    row is demeaned over the WHOLE block, as the reference demeans it:
    the ranks sum their chunks' rows (the last rank also the tail that
    the truncation to ``per·d`` drops) and one all-reduce of those
    sums gives every rank the means. The pairs are offset into the
    stacked ``[2, 3·n_st, per]`` chunk by block."""
    p = _pair_array(pairs)
    n_st, m, n = int(ref1.shape[1]), len(p), int(ref1.shape[-1])
    d, dev = mesh.size, mesh.device
    per, seg, fft_len = _chunk_plan(n, d, max_lag, seg_len, accumulator)
    blocks = (ref1, tgt, ref2)

    def rows(lo, hi):
        return torch.cat([b[..., lo:hi].to(dev, torch.float32)
                          for b in blocks], dim=1)

    xl = rows(mesh.rank * per, (mesh.rank + 1) * per).contiguous()
    sums = xl.sum(-1, dtype=torch.float64)  # [2, 3·n_st]
    if mesh.rank == d - 1 and per * d < n:
        sums += rows(per * d, n).sum(-1, dtype=torch.float64)
    dist.all_reduce(sums, group=mesh.group)
    xl -= (sums / n).to(torch.float32)[..., None]
    all_pairs = (p[None] + np.arange(3)[:, None, None] * n_st).reshape(-1, 2)
    res = _correlate_chunk(xl, all_pairs, mesh, max_lag, seg, fft_len,
                           weighting, 1e-3, "phase", accumulator)
    geo = torch.as_tensor(ref_geo_tdoa, dtype=torch.float32).to(dev)
    return clock_correct_blocks(
        res.delay.reshape(3, m),
        res.delay_std.reshape(3, m),
        res.quality.reshape(3, m),
        res.peak_value.reshape(3, m),
        res.corr.reshape(3, m, -1),
        res.corr_c.reshape(3, m, -1),
        geo, clock_correction,
    )
