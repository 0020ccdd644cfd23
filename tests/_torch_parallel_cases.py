"""The rank side of ``tests/test_torch_parallel.py``: every case of the
file, run inside ONE spawned world (``tdoa_tpu_torch.parallel.launch``),
so the cost of starting the ranks is paid once. A module of its own
because each rank imports the function it runs by name, and this one
imports no JAX.

Every rank runs every case in the same order (a mesh smaller than the
world is a collective ``new_group``); rank 0 returns the results, as
numpy, keyed by the case's name."""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.asarray(a))


def run_cases(cases, device):
    import torch.distributed as dist

    from tdoa_tpu_torch.parallel import (
        correlate_pairs_sharded,
        make_mesh,
        process_blocks_sharded,
    )
    from tdoa_tpu_torch.parallel.dryrun import dryrun_multichip

    out = {}
    for name, kind, n, kw in cases:
        if kind == "dryrun":
            out[name] = dryrun_multichip(n, device)
            continue
        mesh = make_mesh(n, device=device)
        if mesh is None:
            continue
        if kind == "corr":
            res = correlate_pairs_sharded(_t(kw["x"]), kw["pairs"], mesh,
                                          **kw["opts"])
            out[name] = {"delay": res.delay.cpu().numpy(),
                         "delay_std": res.delay_std.cpu().numpy()}
        elif kind == "blocks":
            res = process_blocks_sharded(
                *(_t(b) for b in kw["blocks"]), kw["pairs"], kw["ref_geo"],
                mesh, **kw["opts"])
            out[name] = {"corrected": res[0].cpu().numpy(),
                         "corrected_std": res[6].cpu().numpy()}
        else:
            raise ValueError(kind)
    return out if dist.get_rank() == 0 else None
