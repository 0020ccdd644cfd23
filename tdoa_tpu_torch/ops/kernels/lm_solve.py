"""Kernel 4: the multistart Levenberg-Marquardt solve in one launch.

Replaces no Pallas kernel: the JAX package's ``solve_tdoa_enu``
(``tdoa_tpu/solve/multilateration.py``) is a ``jax.lax.fori_loop`` that
``jit`` compiles into one program. Run eagerly on CPU tensors, the same
loop dispatches ~40 torch operations an iteration, ~1,600 a 9-start,
40-iteration solve. ``csrc/lm_solve.cu`` runs every start and every
iteration in one launch (one warp a start); its plain version is
``solve_tdoa_enu``'s own loop on the CPU
(``tdoa_tpu_torch/solve/multilateration.py``), which dispatches here for
a CUDA device.

A solve's inputs are packed on the host into one pinned buffer
(``pack_inputs``: a pair's ``si, rd | sj, w`` as two float4, then the
starts) with room behind them for the output rows ``[S, 4]`` (``x, y,
z, rms`` a start): the buffer reaches the card in one copy and comes
back in one (``unpack_outputs``).
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

MAX_STARTS = 32  # one warp a start, one CTA
MAX_PAIRS = 232448 // 32  # the pairs' 32 bytes each in 227 KB of shared memory
PAIR_FLOATS = 8
START_FLOATS = 4


def input_floats(m: int, S: int) -> int:
    """The packed input's length in float32 values."""
    return PAIR_FLOATS * m + START_FLOATS * S


def pack_inputs(buf: np.ndarray, si, sj, rd, w, x0) -> None:
    """Write a solve's inputs into the float32 buffer ``buf`` (at least
    ``input_floats(m, S)`` long): ``[m, 8]`` pairs (``si.xyz, rd,
    sj.xyz, w``), then ``[S, 4]`` starts (``x, y, z, 0``)."""
    m, S = len(rd), len(x0)
    pairs = buf[:PAIR_FLOATS * m].reshape(m, PAIR_FLOATS)
    pairs[:, 0:3] = si
    pairs[:, 3] = rd
    pairs[:, 4:7] = sj
    pairs[:, 7] = w
    starts = buf[PAIR_FLOATS * m:input_floats(m, S)].reshape(S, START_FLOATS)
    starts[:, 0:3] = x0
    starts[:, 3] = 0.0


def unpack_outputs(out: np.ndarray):
    """``[S, 4]`` output rows (float32, flat) → (x ``[S, 3]``, rms
    ``[S]``) as new host tensors."""
    out = out.reshape(-1, START_FLOATS)
    return (torch.from_numpy(out[:, :3].copy()),
            torch.from_numpy(out[:, 3].copy()))


def _check(si, sj, rd, w, x0, iters: int, n_dim: int):
    for name, t in (("si", si), ("sj", sj), ("rd", rd), ("w", w),
                    ("x0", x0)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 tensor")
        if t.device.type != "cpu":
            raise ValueError(f"{name} must be a host tensor (the wrapper "
                             f"packs the inputs into one pinned copy)")
    m = rd.shape[0] if rd.dim() == 1 else -1
    if not 1 <= m <= MAX_PAIRS:
        raise ValueError(f"rd must be [m] with 1 <= m <= {MAX_PAIRS}")
    if si.shape != (m, 3) or sj.shape != (m, 3) or w.shape != (m,):
        raise ValueError(f"si, sj must be [{m}, 3] and w [{m}]")
    if x0.dim() != 2 or x0.shape[1] != 3 \
            or not 1 <= x0.shape[0] <= MAX_STARTS:
        raise ValueError(f"x0 must be [S, 3] with 1 <= S <= {MAX_STARTS}")
    if n_dim not in (2, 3) or iters < 0:
        raise ValueError("n_dim must be 2 or 3 and iters >= 0")
    return m, x0.shape[0]


def lm_solve(si: torch.Tensor, sj: torch.Tensor, rd: torch.Tensor,
             w: torch.Tensor, x0: torch.Tensor, iters: int, n_dim: int,
             device) -> tuple:
    """Every start of ``x0`` ``[S, 3]`` through ``iters`` LM iterations
    over the pairs (``si``, ``sj`` ``[m, 3]`` ENU meters, ``rd`` ``[m]``
    range differences, ``w`` ``[m]`` weights), on the CUDA ``device``:
    one copy in, one launch of ``csrc/lm_solve.cu``, one copy out, on
    the current stream, which it then waits for. Inputs are float32 host
    tensors; returns (x ``[S, 3]``, rms ``[S]``) as float32 host tensors
    and counts the launch in ``lm_solve.launches`` (and, by ``(S, m,
    n_dim)``, in ``lm_solve.launch_shapes``). ``n_dim`` 2 freezes
    the up-coordinate at its start. Raises for a device that is not an
    sm_90 card."""
    from tdoa_tpu_torch.ops.kernels import _build
    from tdoa_tpu_torch.utils.platform import require_sm90

    m, S = _check(si, sj, rd, w, x0, iters, n_dim)
    device = torch.device(device)
    require_sm90(device)
    lib = _build.load()
    n_in = input_floats(m, S)
    # One pinned buffer and one on the card, each the packed input and
    # then the output rows: the whole buffer goes over and comes back.
    host = torch.empty(n_in + START_FLOATS * S, dtype=torch.float32,
                       pin_memory=True)
    h = host.numpy()
    pack_inputs(h, si.numpy(), sj.numpy(), rd.numpy(), w.numpy(),
                x0.numpy())
    buf = torch.empty_like(host, device=device)
    stream = torch.cuda.current_stream(device)
    # The launch and its shared-memory attribute go to the current card.
    with torch.cuda.device(device):
        buf.copy_(host, non_blocking=True)
        err = lib.tdoa_lm_solve(
            ctypes.c_void_p(buf.data_ptr()), m, S, n_dim, int(iters),
            ctypes.c_void_p(buf.data_ptr() + 4 * n_in),
            ctypes.c_void_p(stream.cuda_stream))
        if err != 0:
            raise RuntimeError(
                f"lm_solve kernel launch failed: CUDA error {err}")
        lm_solve.launches += 1
        lm_solve.launch_shapes[(S, m, n_dim)] += 1
        host.copy_(buf, non_blocking=True)
    stream.synchronize()
    return unpack_outputs(h[n_in:])


lm_solve.launches = 0
lm_solve.launch_shapes = collections.Counter()
