"""Start the ranks of a mesh: what the reference's mesh gets for free.

The JAX package runs one controller that sees every device. A
``torch.distributed`` mesh is one process per rank, so something has to
start them, join them into a process group and hand their results back:
``spawn(fn, n, device, *args)`` runs ``fn(*args)`` on ``n`` ranks and
returns each rank's result, in rank order.

- The ranks are started with the ``spawn`` method of
  ``torch.multiprocessing``: a forked child cannot use CUDA, and the
  parent initialises nothing of CUDA here.
- They meet through a ``FileStore`` in a fresh temporary directory, not
  a TCP port, so any number of worlds can start at once on one host.
- The backend is gloo on the CPU. On the card it is NCCL when every rank
  has its own card, and gloo on CUDA tensors when ranks share one (NCCL
  refuses two ranks on one device). Rank 0 prints it.
- What ``fn`` returns must pickle: it comes back through a file of the
  temporary directory (a kernel's launch counts, which live in the
  rank's own process, come back that way).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch


def _rank_main(rank: int, n: int, device: str, tmp: str, fn, args) -> None:
    import torch.distributed as dist

    backend = "gloo"
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(rank % cards)
        if n <= cards:
            backend = "nccl"
    else:
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(minutes=10))
    try:
        if rank == 0:
            print(f"parallel.launch: {n} rank(s), backend {backend}, "
                  f"device {device}", flush=True)
        out = fn(*args)
        with open(os.path.join(tmp, f"result-{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, device="cuda", *args) -> list:
    """Run ``fn(*args)`` on ``n`` ranks on ``device`` (``"cuda"``: rank r
    on card ``r % device_count``; ``"cpu"``) and return their results
    in rank order. ``fn`` must be importable by name (a module-level
    function); a rank that raises ends the world, and the error is
    raised here."""
    import torch.multiprocessing as mp

    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    with tempfile.TemporaryDirectory(prefix="tdoa_ranks_") as tmp:
        mp.start_processes(_rank_main, args=(n, str(device), tmp, fn, args),
                           nprocs=n, join=True, start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"result-{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
    return out
