"""Device helpers: which torch device runs the pipeline, and whether it
can run the hand-written Hopper kernels (compiled for ``sm_90a`` only).

There is no interpret mode: a CUDA tensor goes through the CUDA kernels
or an error, a CPU tensor through the kernels' plain torch versions.
The entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The card. Raises when no CUDA device is visible: the CPU runs the
    pipeline only when the caller asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: tdoa_tpu_torch runs on the card by "
            "default; pass device=\"cpu\" (or --device cpu on the command "
            "line) to run the kernels' plain torch versions on the CPU")
    return torch.device("cuda")


def is_sm90(device: torch.device) -> bool:
    """Is ``device`` CUDA, and of compute capability 9.0 (H100/H200), the
    only target the kernels are built for?"""
    device = torch.device(device)
    return (device.type == "cuda"
            and torch.cuda.get_device_capability(device) == (9, 0))


def require_sm90(device: torch.device) -> None:
    """Raise unless ``device`` can run the ``sm_90a`` kernels."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"{device} is not a CUDA device")
    if not is_sm90(device):
        cap = torch.cuda.get_device_capability(device)
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a (9.0)"
        )
