"""Carry the JAX package's state into the port.

The system has no learned weights: its state is the correlator's
accumulator banks, the station table and the configuration. These two
functions turn the JAX package's host copies of that state into the
port's — so a test can feed ``tdoa_tpu``'s kernel-1 banks into this
package's probe and finish and check each stage on its own. Inputs are
numpy arrays (``np.asarray`` of the JAX outputs); nothing here imports
JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from tdoa_tpu_torch.pipeline.processor import ProcessorConfig


def banks_from_planar(cross_re, cross_im, psd, energy,
                      device: Optional[torch.device] = None):
    """Planar ``(re, im)`` cross banks ``[K, m, F]`` (or ``[m, F]``),
    ``psd [K, n_st, F]`` and ``energy [K, n_st]`` (numpy, float32) →
    (cross complex64, psd float32, energy float32) tensors on
    ``device``."""
    re = np.array(cross_re, np.float32)
    im = np.array(cross_im, np.float32)
    if re.shape != im.shape:
        raise ValueError(f"re {re.shape} and im {im.shape} differ")
    cross = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    psd_t = torch.from_numpy(np.array(psd, np.float32))
    energy_t = torch.from_numpy(np.array(energy, np.float32))
    if device is not None:
        cross, psd_t, energy_t = (t.to(device) for t in
                                  (cross, psd_t, energy_t))
    return cross, psd_t, energy_t


def config_from_fields(fields: Dict[str, Any]) -> ProcessorConfig:
    """A ``tdoa_tpu`` ``ProcessorConfig`` field dict
    (``dataclasses.asdict``) → the port's config. Every field carries
    over; an unknown field raises."""
    known = {f.name for f in dataclasses.fields(ProcessorConfig)}
    extra = set(fields) - known
    if extra:
        raise ValueError(f"unknown ProcessorConfig fields: {sorted(extra)}")
    f = dict(fields)
    if f.get("prior") is not None:
        f["prior"] = tuple(float(v) for v in f["prior"])
    return ProcessorConfig(**f)
