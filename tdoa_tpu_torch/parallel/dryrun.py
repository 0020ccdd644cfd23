"""The multi-rank dry run: the sharded step at every mesh size, held to
the one-device path.

Torch port of ``__graft_entry__.dryrun_multichip``:

    python -m tdoa_tpu_torch.parallel.dryrun --ranks N [--device cpu]

starts ``N`` ranks (``parallel/launch.py``; the card by default, rank r
on card ``r % device_count``) and certifies the sharding math, not one
lucky configuration:

- the segmented correlator sharded over each mesh size n ∈ {2, 4, 8}
  (those ≤ N; the first n ranks) runs the full 3-block clock-corrected
  step on a 3-station scene, and at the largest n on a 5-station scene,
  each asserting max |Δ corrected TDOA| < 1e-3 samples against
  ``process_blocks`` on one device; the solver fixes the 3-station
  result;
- kernel 1 on every rank's chunk (``accumulator="pallas"``) at the
  largest n, against ``correlate_pairs_fused`` on one device.

The segment is pinned (``1024 − 128``) and the capture is a multiple
of n·seg for every n, so the sharded and unsharded runs segment at the
same sample boundaries: they agree up to the all-reduce's summation
order, and 1e-3 is a certificate, not a statistical bound. Exits
non-zero if any comparison fails.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

MAX_LAG = 128
# seg + max_lag = 1024 = next_pow2(seg): resolve_seg keeps this segment
# on both paths, and it is below auto_seg_len's 4096 floor, so the
# one-device path cannot re-split it.
SEG = 1024 - MAX_LAG
TOL = 1e-3  # samples


def demo_blocks(n_st: int = 3, length: int = 1 << 14,
                seed: int = 0) -> list:
    """Three planar f32 [2, n_st, length] blocks (REF₁, TGT, REF₂) of an
    FM source delayed per station (numpy, seeded: the reference dry
    run's ``_demo_blocks``)."""
    rng = np.random.default_rng(seed)
    blocks = []
    for b in range(3):
        audio = rng.standard_normal(length).astype(np.float32)
        phase = 2 * np.pi * 25e3 / 2e6 * np.cumsum(audio)
        src = np.exp(1j * phase).astype(np.complex64)
        f = np.fft.fftfreq(length)
        sigs = []
        for k in range(n_st):
            # Distinct geometric delays in the TGT block (b == 1), so the
            # clock-corrected TDOAs are not trivial.
            d = 10.0 * k + 3.0 * b + (7.0 * k if b == 1 else 0.0)
            delayed = np.fft.ifft(np.fft.fft(src) * np.exp(-2j * np.pi * f * d))
            noise = 0.01 * (rng.standard_normal(length)
                            + 1j * rng.standard_normal(length))
            sigs.append((delayed + noise).astype(np.complex64))
        x = np.stack(sigs)
        blocks.append(torch.from_numpy(
            np.stack([x.real, x.imag]).astype(np.float32)))
    return blocks


def dryrun_multichip(n_ranks: int, device=None) -> dict:
    """The dry run on this rank (every rank of a world of ``n_ranks``
    calls it). Returns the largest deviation of each comparison;
    raises ``AssertionError`` where one exceeds ``TOL``."""
    import torch.distributed as dist

    from tdoa_tpu_torch.ops.corr import correlate_pairs_fused
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN
    from tdoa_tpu_torch.parallel import (
        correlate_pairs_sharded,
        make_mesh,
        process_blocks_sharded,
    )
    from tdoa_tpu_torch.pipeline.processor import process_blocks
    from tdoa_tpu_torch.solve.multilateration import (
        solve_tdoa_enu,
        station_pairs,
    )

    rank = dist.get_rank()
    dev = make_mesh(device=device).device
    sweep = [n for n in (2, 4, 8) if n <= n_ranks] or [n_ranks]
    length = max(sweep) * SEG * 2  # a multiple of every n × seg
    report = {}

    def say(text):
        if rank == 0:
            print(text, flush=True)

    def run_scene(n_st, seed, meshes):
        blocks = demo_blocks(n_st=n_st, length=length, seed=seed)
        pairs = station_pairs(n_st)
        ref_geo = torch.zeros(len(pairs))
        single = process_blocks(*(b.to(dev) for b in blocks), pairs,
                                ref_geo.to(dev), max_lag=MAX_LAG,
                                seg_len=SEG, weighting="ht")
        corrected_1 = single[0].double().cpu().numpy()
        for n in meshes:
            mesh = make_mesh(n, device=device)  # every rank: collective
            if mesh is None:
                continue
            out = process_blocks_sharded(*blocks, pairs, ref_geo, mesh,
                                         max_lag=MAX_LAG, seg_len=SEG,
                                         weighting="ht")
            corrected_n = out[0].double().cpu().numpy()
            dmax = float(np.abs(corrected_n - corrected_1).max())
            report[f"xla n={n} ({n_st} st)"] = dmax
            assert dmax < TOL, (
                f"{n_st}-station mesh n={n}: sharded corrected TDOAs "
                f"deviate {dmax:.2e} samples from the unsharded path")
            say(f"dryrun_multichip n={n} ({n_st} st): corrected TDOAs "
                f"{corrected_n.round(2)}, max |Δ| vs one device {dmax:.1e}")
        return pairs, single

    # The 3-station sweep over every mesh size, and the solver on it.
    pairs3, single3 = run_scene(3, seed=0, meshes=sweep)
    stations_enu = torch.tensor(
        [[0.0, 0.0, 0.0], [8000.0, 2000.0, 10.0], [3000.0, 9000.0, -5.0]])
    rd = single3[0].float().cpu() * (299792458.0 / 2e6)
    pos, _ = solve_tdoa_enu(stations_enu, torch.as_tensor(pairs3), rd,
                            device=dev)
    say(f"dryrun_multichip solver fix ENU {pos.numpy().round(1)}")

    # The 5-station scene (10 pairs) at the largest mesh.
    run_scene(5, seed=1, meshes=[max(sweep)])

    # Kernel 1 on every rank's chunk, one all-reduce, against the fused
    # correlator on one device.
    n_top = max(sweep)
    base_pairs = ((0, 1), (0, 2), (1, 2))
    xw = demo_blocks(length=SEG_LEN * n_top)[0]
    fused_1 = correlate_pairs_fused(xw.to(dev), base_pairs, max_lag=MAX_LAG,
                                    weighting="ht")
    mesh = make_mesh(n_top, device=device)
    if mesh is not None:
        res = correlate_pairs_sharded(xw, base_pairs, mesh, max_lag=MAX_LAG,
                                      accumulator="pallas")
        d_sh = res.delay.double().cpu().numpy()
        dmax = float(np.abs(d_sh - fused_1.delay.double().cpu().numpy()).max())
        report[f"pallas n={n_top}"] = dmax
        assert dmax < TOL, (f"kernel-1-sharded delays deviate {dmax:.2e} "
                            f"samples from the unsharded fused path")
        say(f"dryrun_multichip({n_top}) kernel-1-sharded delays: "
            f"{d_sh.round(2)}, max |Δ| vs unsharded fused {dmax:.1e}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tdoa_tpu_torch.parallel.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8,
                    help="world size; meshes of 2, 4, 8 ranks up to it")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions (default: "
                         "the card)")
    args = ap.parse_args(argv)
    from tdoa_tpu_torch.parallel.launch import spawn

    device = args.device or "cuda"
    reports = spawn(dryrun_multichip, args.ranks, device, args.ranks,
                    device)
    worst = max(max(r.values()) for r in reports if r)
    print(f"dryrun_multichip: {args.ranks} ranks on {device}, every "
          f"comparison within {TOL:g} samples (largest {worst:.1e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
