"""Sequence-parallel scaling characterization of the PyTorch port.

The port's counterpart of ``scripts/mesh_scaling.py``, in two halves.

1. **Correctness + overhead on CPU ranks.** A fixed total problem
   (3 stations × 2²² samples, ``max_lag`` 2048, HT weighting) runs
   through ``parallel.correlate_pairs_sharded`` on meshes of the first
   d = 1, 2, 4, 8 ranks of one world of 8 gloo ranks on the CPU
   (``parallel.launch.spawn(fn, 8, "cpu")``), each held to the
   unsharded ``ops.corr.correlate_pairs`` within 1e-3 sample. The
   segment is 4096 samples (with ``max_lag`` 2048 it stays 4096 in an
   FFT of 8192), so the capture splits into whole segments on every
   mesh and the sharded program differs from the unsharded one only in
   its summation order: 1e-3 is a certificate, as in
   ``parallel.dryrun``. The ranks time-slice the host's cores, so the
   wall times are overhead, not a scaling figure.
2. **An analytic link model on the card's own numbers.** Each rank
   accumulates its chunk's cross-spectra and ONE all-reduce merges the
   accumulator stack, whose size does not depend on the capture's
   length. The single-card rate is measured here (``--device cuda``,
   the default): ``process_blocks`` on the kernel route over a 30 s,
   3-station window on the card, in samples per second; the link is
   NVLink 4 on the H100 SXM, 450 GB/s each way (900 GB/s total), a
   data-sheet figure. Without a card the half is not run, and the
   script says so and exits 0 after the CPU half.

Output: markdown tables.

    python3 scripts/mesh_scaling_torch.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

N_ST = 3
MAX_LAG = 2048
SEG_LEN = 4096
SHIFTS = (0, 11, 23)
TOL = 1e-3  # samples, sharded against unsharded
FS = 2e6
# NVLink 4 on the H100 SXM: 18 links, 900 GB/s total, 450 GB/s each way
# (NVIDIA H100 data sheet).
NVLINK_BYTES_PER_S = 450e9


def _capture(n: int) -> torch.Tensor:
    """Planar f32 [2, 3, n]: one complex white-noise source (numpy seed
    0), circularly shifted by 0, 11 and 23 samples per station."""
    rng = np.random.default_rng(0)
    base = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    sig = np.stack([np.roll(base, s) for s in SHIFTS])
    return torch.from_numpy(np.stack([sig.real, sig.imag]).astype(np.float32))


def _timed(fn, runs: int = 3) -> float:
    fn()  # warm-up
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _cpu_rank(n: int, ds) -> dict:
    """One rank of the CPU half. Rank 0 first times the unsharded path
    alone while the others wait; then every mesh size d in ``ds`` runs
    on the first d ranks (a warm-up, then timed runs, each started at a
    barrier). Rank 0 returns the table's rows."""
    import torch.distributed as dist

    from tdoa_tpu_torch.ops.corr import correlate_pairs
    from tdoa_tpu_torch.parallel import correlate_pairs_sharded, make_mesh
    from tdoa_tpu_torch.solve.multilateration import station_pairs

    x = _capture(n)
    pairs = station_pairs(N_ST)
    kw = dict(max_lag=MAX_LAG, seg_len=SEG_LEN, weighting="ht")
    rank = dist.get_rank()
    out = {}
    if rank == 0:
        single = correlate_pairs(x, pairs, **kw)
        out["single"] = {"delay": single.delay.double().numpy(),
                         "wall_s": _timed(
                             lambda: correlate_pairs(x, pairs, **kw))}
    dist.barrier()
    for d in ds:
        mesh = make_mesh(d, device="cpu")  # every rank: collective
        if mesh is None:
            dist.barrier()
            continue

        def run(mesh=mesh):
            dist.barrier(group=mesh.group)
            return correlate_pairs_sharded(x, pairs, mesh, **kw)

        res = run()
        wall = _timed(run)
        if rank == 0:
            out[d] = {"delay": res.delay.double().numpy(), "wall_s": wall}
        dist.barrier()
    return out if rank == 0 else None


def cpu_half(n: int = 1 << 22, ds=(1, 2, 4, 8)) -> list:
    """The CPU half: prints its table; returns (d, wall s, max |Δ| vs
    unsharded, max |delay − planted|) per mesh size; raises
    ``RuntimeError`` if a mesh misses the unsharded path by 1e-3."""
    from tdoa_tpu_torch.parallel.launch import spawn
    from tdoa_tpu_torch.solve.multilateration import station_pairs

    if n % (max(ds) * SEG_LEN):
        raise ValueError(f"{n} samples do not split into whole "
                         f"{SEG_LEN}-sample segments over {max(ds)} ranks")
    res = spawn(_cpu_rank, max(ds), "cpu", n, tuple(ds))[0]
    want = np.array([SHIFTS[j] - SHIFTS[i] for i, j in station_pairs(N_ST)])
    single = res["single"]
    rows = []
    for d in ds:
        dev = float(np.abs(res[d]["delay"] - single["delay"]).max())
        err = float(np.abs(res[d]["delay"] - want).max())
        rows.append((d, res[d]["wall_s"], dev, err))
    print(f"## Sequence parallelism on CPU ranks ({max(ds)} gloo ranks, "
          f"{os.cpu_count()} host cores, each rank "
          f"{max(1, (os.cpu_count() or 1) // max(ds))} torch thread(s))\n")
    print(f"Fixed total problem: {N_ST} stations x {n / 1e6:.2f} Msamples, "
          f"max_lag {MAX_LAG}, HT, segments of {SEG_LEN}. Ranks "
          f"time-slice the host; not a scaling figure.\n")
    print("| ranks | wall s | vs single-path | largest deviation from "
          "unsharded (samples) | largest error against planted (samples) |")
    print("|---|---|---|---|---|")
    err1 = float(np.abs(single["delay"] - want).max())
    print(f"| single-device path | {single['wall_s']:.3f} | 1.00x | — "
          f"| {err1:.2e} |")
    for d, wall, dev, err in rows:
        print(f"| mesh d={d} | {wall:.3f} | {wall / single['wall_s']:.2f}x "
              f"| {dev:.2e} | {err:.2e} |")
    worst = max(r[2] for r in rows)
    if not worst < TOL:
        raise RuntimeError(f"a mesh deviates {worst:.2e} samples from the "
                           f"unsharded path (tol {TOL:g})")
    print(f"\nEvery mesh within {TOL:g} sample of the unsharded path "
          f"(largest {worst:.2e}).\n")
    return rows


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def analytic_half(device: str = "cuda", seconds: float = 30.0) -> dict:
    """The link model on the card's measured rate: prints the model;
    returns the rate and the all-reduce size."""
    import station_sweep_torch as sweep
    from tdoa_tpu_torch.ops.corr import split_k
    from tdoa_tpu_torch.ops.kernels.corr_accum import FFT_LEN, SEG_LEN as KSEG

    dev = torch.device(device)
    blocks = sweep.make_blocks(N_ST, seconds, 7, dev)
    L = int(blocks[0].shape[-1])

    def run():
        sweep.run(blocks)
        torch.cuda.synchronize(dev)

    run()  # warm-up: the kernels' build and launch plans
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    t_run = statistics.median(ts)
    n_window = 3 * N_ST * L
    rate = n_window / t_run
    rows, m = 3 * N_ST, 3 * N_ST * (N_ST - 1) // 2
    print(f"## Link model on the card's numbers ({_smi()})\n")
    print(f"- Single card: `process_blocks` on the kernel route, {N_ST} "
          f"stations, a {seconds:g} s window (3 blocks x {L} samples): "
          f"median of 5 runs {t_run * 1e3:.2f} ms, "
          f"{rate / 1e9:.3f} Gsamples/s (measured in this run).")
    print(f"- Link: NVLink 4 on the H100 SXM, "
          f"{NVLINK_BYTES_PER_S / 1e9:.0f} GB/s each way (data sheet, not "
          f"measured); a ring all-reduce moves 2(d-1)/d of the buffer per "
          f"card.")
    out = {"rate_samples_per_s": rate, "run_s": t_run, "card": _smi()}
    for window_s in (1.0, 10.0, 30.0, 100.0):
        n_total = window_s * FS * N_ST
        for d in (2, 4, 8):
            # The split-σ banks as process_blocks_sharded picks them.
            K = split_k(int(window_s * FS / 3) // d // KSEG * d)
            while K > 1 and d % K != 0:
                K //= 2
            K = max(K, 1)
            # The accumulator stack of process_blocks_sharded on the
            # kernel route: K banks of the 3·n_st stacked rows' cross
            # spectra (complex), PSDs and energies, f32.
            buf = 4 * K * ((2 * m + rows) * FFT_LEN + rows)
            t_comp = n_total / d / rate
            t_comm = 2 * (d - 1) / d * buf / NVLINK_BYTES_PER_S
            eff = t_comp / (t_comp + t_comm)
            out[(window_s, d)] = (t_comp, t_comm, eff, buf)
            print(f"- {window_s:.0f} s window, {d} cards: compute "
                  f"{t_comp * 1e3:.2f} ms + all-reduce {t_comm * 1e3:.3f} ms "
                  f"({buf / 1e6:.1f} MB, K = {K}) -> efficiency "
                  f"{eff * 100:.1f}%")
    print("\nA model, not a measurement: one card's rate divided by d, plus "
          "a ring all-reduce at the link's data-sheet rate.")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the card for the analytic half's measured rate "
                         "(default); 'cpu' runs the CPU half alone")
    args = ap.parse_args(argv)
    cpu_half()
    if torch.device(args.device).type != "cuda" \
            or not torch.cuda.is_available():
        print("The analytic half needs the card: its rate is measured "
              "there (run with --device cuda where a card is visible).")
        return 0
    analytic_half(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
