"""Correlation-peak location with sub-sample refinement (torch port of
``tdoa_tpu.ops.peaks``): integer argmax over the last axis plus a
three-point parabolic fit, batched over the leading axes."""

from __future__ import annotations

from typing import Tuple

import torch


def parabolic_peak(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sub-sample argmax of ``y`` along the last axis.

    Returns ``(pos, value)``: ``pos`` is the float index (integer argmax
    + parabolic offset in [-0.5, 0.5]), ``value`` the interpolated peak
    height. At a clamped edge the fit degrades to the integer peak.
    """
    n = y.shape[-1]
    idx = torch.argmax(y, dim=-1)
    ic = idx.clamp(1, n - 2)
    ym1 = torch.gather(y, -1, (ic - 1).unsqueeze(-1)).squeeze(-1)
    y0 = torch.gather(y, -1, ic.unsqueeze(-1)).squeeze(-1)
    yp1 = torch.gather(y, -1, (ic + 1).unsqueeze(-1)).squeeze(-1)
    denom = ym1 - 2.0 * y0 + yp1
    safe = torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))
    offset = torch.where(denom.abs() > 1e-12, 0.5 * (ym1 - yp1) / safe,
                         torch.zeros_like(denom))
    offset = offset.clamp(-0.5, 0.5)
    interior = (idx >= 1) & (idx <= n - 2)
    pos = idx.to(torch.float32) + torch.where(
        interior, offset, torch.zeros_like(offset))
    value = torch.where(interior, y0 - 0.25 * (ym1 - yp1) * offset,
                        y.amax(dim=-1))
    return pos, value


def peak_quality(y: torch.Tensor, guard: int = 8) -> torch.Tensor:
    """Peak-to-sidelobe ratio along the last axis: the peak over the
    mean magnitude outside a ±guard zone around it."""
    n = y.shape[-1]
    idx = torch.argmax(y, dim=-1)
    peak = y.amax(dim=-1)
    pos = torch.arange(n, device=y.device)
    mask = (pos - idx.unsqueeze(-1)).abs() > guard
    floor = torch.where(mask, y, torch.zeros_like(y)).sum(-1) / mask.sum(
        -1).clamp(min=1)
    return peak / floor.clamp(min=1e-12)
