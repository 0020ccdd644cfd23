"""Tracing and per-stage timing (torch port of
``tdoa_tpu.utils.profiling``).

Two layers:
- ``trace(dir)``: a context manager around ``torch.profiler`` that writes
  a Chrome trace (``.json``, loadable in Perfetto or chrome://tracing)
  of everything inside it, the card's kernels included;
- ``StageTimer``: wall-clock stage accounting whose stage edges
  synchronise the card, so stage times measure the work and not only its
  launches under asynchronous execution. Each stage is also a
  ``torch.profiler.record_function`` range, so a trace taken around the
  run labels the host's time by stage.
"""

from __future__ import annotations

import contextlib
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


def range_label(name: str) -> str:
    """A stage's name as a profiler range: ASCII, since the trace's
    exporter names a range with other characters "unknown" ("re-solve
    (echo-bias σ)" → "re-solve (echo-bias sigma)")."""
    return name.replace("σ", "sigma").encode("ascii", "replace").decode()


class StageTimer:
    """Accumulates (stage → seconds); each stage ends by synchronising
    the card (when CUDA is in use), so its time includes the device
    work it launched, and is a profiler range named ``range_label``.
    The report keeps the stages' own names.

    Usage::

        timer = StageTimer()
        with timer.stage("correlate"):
            out = correlate(...)
    """

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.order: List[str] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        with torch.profiler.record_function(range_label(name)):
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

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"total {total*1e3:8.1f} ms"]
        for name in self.order:
            t = self.times[name]
            lines.append(
                f"  {name:<20s} {t*1e3:8.1f} ms  ({100*t/max(total,1e-12):4.1f}%)"
            )
        return "\n".join(lines)


# ``TDOAProcessor.ingest_diag``'s times, in report order, and their labels.
_INGEST_TIMES = (("read_s", "file read"), ("read_busy_s", "reads summed"),
                 ("h2d_s", "copy wait"),
                 ("gather_s", "gather"), ("wait_s", "pinned wait"),
                 ("transfer_stream_s", "copy stream"))


def ingest_report(diag: dict) -> str:
    """A window's ingest counters (``TDOAProcessor.ingest_diag``) as
    report lines: each time in ms, and the bytes copied to the card with
    their rate over the ingest's time (the batch ingest's file reads and
    waits for the copies, which overlap the copies; the overlapped
    ingest's copy stream)."""
    lines = [f"  {label:<20s} {diag[key] * 1e3:8.1f} ms"
             for key, label in _INGEST_TIMES if diag.get(key) is not None]
    if "h2d_bytes" in diag:
        nbytes = diag["h2d_bytes"]
        copy_s = (diag["read_s"] + diag.get("h2d_s", 0.0)
                  if "read_s" in diag else diag.get("transfer_stream_s"))
        rate = (f"  ({nbytes / copy_s / 1e9:.2f} GB/s)"
                if nbytes and copy_s else "")
        lines.append(f"  {'bytes to the card':<20s} {nbytes:d} B{rate}")
    for key, label in (("readers", "readers"),
                       ("staged_chunks", "ring chunks"),
                       ("pinned_allocs", "pinned allocs")):
        if key in diag:
            lines.append(f"  {label:<20s} {diag[key]:d}")
    if "n_chunks" in diag:
        lines.append(f"  {'chunks':<20s} {diag['n_chunks']} of "
                     f"{diag['chunk_segs']} segments")
    return "\n".join(lines)


def checks_report(diag: dict) -> str:
    """What the stage "checks" counted (``TDOAProcessor.ingest_diag``):
    the outputs' fetch to the host in ms, with its bytes and their rate,
    and the pairs correlated and weighted; then the window's launches of
    kernel 4, the solves' LM (0 on the CPU)."""
    lines = []
    if diag.get("fetch_s") is not None:
        nbytes = diag["d2h_bytes"]
        rate = (f"  ({nbytes / diag['fetch_s'] / 1e9:.2f} GB/s)"
                if nbytes and diag["fetch_s"] else "")
        lines += [f"  {'fetch':<20s} {diag['fetch_s'] * 1e3:8.1f} ms",
                  f"  {'bytes to the host':<20s} {nbytes:d} B{rate}"]
    for key, label in (("pairs", "pairs"),
                       ("pairs_weighted", "pairs weighted"),
                       ("lm_launches", "LM launches")):
        if key in diag:
            lines.append(f"  {label:<20s} {diag[key]:d}")
    return "\n".join(lines)
