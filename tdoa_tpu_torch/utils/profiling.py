"""Tracing and per-stage timing (torch port of
``tdoa_tpu.utils.profiling``).

Two layers:
- ``trace(dir)``: a context manager around ``torch.profiler`` that writes
  a Chrome trace (``.json``, loadable in Perfetto or chrome://tracing)
  of everything inside it, the card's kernels included;
- ``StageTimer``: wall-clock stage accounting whose stage edges
  synchronise the card, so stage times measure the work and not only its
  launches under asynchronous execution.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace into ``log_dir`` as
    ``trace-<pid>-<time>.json``: host activity, and the card's kernels
    and copies when CUDA is available (a process that has not touched
    the card yet when the trace starts is traced all the same)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of every tensor in ``x`` (tensors, tuples, lists,
    dicts, NamedTuples and dataclasses, nested)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    return out


def sync(x) -> None:
    """Wait for the work producing ``x``: synchronise each card that holds
    one of its tensors."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulates (stage → seconds); each stage ends by synchronising
    the card (when CUDA is in use), so its time includes the device
    work it launched.

    Usage::

        timer = StageTimer()
        with timer.stage("correlate"):
            out = correlate(...)
            timer.observe(out)   # optional sync point inside the stage
    """

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.order: List[str] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if name not in self.times:
                self.order.append(name)
                self.times[name] = 0.0
            self.times[name] += dt

    def observe(self, x) -> None:
        sync(x)

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"total {total*1e3:8.1f} ms"]
        for name in self.order:
            t = self.times[name]
            lines.append(
                f"  {name:<20s} {t*1e3:8.1f} ms  ({100*t/max(total,1e-12):4.1f}%)"
            )
        return "\n".join(lines)
