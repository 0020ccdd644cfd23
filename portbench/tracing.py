"""Spans and the device trace of a traced run (``--trace 1``).

``Tracer`` runs ``torch.profiler`` over the first ``TRACE_SECONDS`` of
the measured window (the windows that start in them; a whole window's
trace of the solve's many small host ops runs to a GB of JSON) and
keeps, per traced window, the stages' seconds and the overlapped
ingest's counters, and the port's kernel launches by shape over the
traced windows. ``SpanTimer`` is the object it hands ``TDOAProcessor
.timer``: each
stage the program opens becomes a ``torch.profiler.record_function``
range (so the trace labels the host's time by stage) and its wall time,
the card synchronised at its end as the program's own ``StageTimer``
does, is summed per window. ``reduce`` reads the profiler's Chrome trace
of the measured window: the device's busy time (the union of kernel,
copy and memset intervals), device time by operation, and the idle gaps
labelled by the stage the host had open."""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import sys
import time
from typing import Dict, List, Tuple

import torch

WINDOW = "portbench.window"
TRACE_SECONDS = 15.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class SpanTimer:
    """``stage(name)`` context manager: a profiler range and the stage's
    seconds in ``self.seconds`` (reset per window by the run)."""

    def __init__(self):
        self.seconds: Dict[str, float] = collections.defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str):
        # The trace's exporter names a range with other than ASCII
        # letters "unknown": "re-solve (echo-bias σ)" → "... sigma)".
        label = name.replace("σ", "sigma").encode("ascii", "replace").decode()
        with torch.profiler.record_function(label):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0


class Tracer:
    """The profiler, the span timer and the launch counters of the traced
    part of a window."""

    def __init__(self, proc, counters: dict):
        from torch.profiler import ProfilerActivity, profile

        self.proc = proc
        self.counters = counters
        self.before = {k: collections.Counter(fn.launch_shapes)
                       for k, fn in counters.items()}
        self.timer = SpanTimer()
        self.windows: List[dict] = []
        self.launches: Dict[str, collections.Counter] = {}
        proc.timer = self.timer
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.active = True

    @contextlib.contextmanager
    def window(self):
        if not self.active:
            yield
            return
        self.timer.seconds.clear()
        with torch.profiler.record_function(WINDOW):
            yield
        self.windows.append({"stages": dict(self.timer.seconds),
                             "ingest": dict(self.proc.ingest_diag)})

    def stop(self) -> None:
        if not self.active:
            return
        self.active = False
        self.proc.timer = None
        self.prof.__exit__(None, None, None)
        self.launches = {k: collections.Counter(fn.launch_shapes)
                         - self.before[k] for k, fn in self.counters.items()}

    def read(self, tmp: str):
        """(windows, launches, TraceSummary) of the traced windows; the
        Chrome trace goes through ``tmp`` and is removed."""
        path = os.path.join(tmp, "trace.json")
        t0 = time.perf_counter()
        self.prof.export_chrome_trace(path)
        self.prof = None
        summary = TraceSummary(path)
        print(f"trace: {len(self.windows)} windows, {os.path.getsize(path)} "
              f"B, exported and read in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        os.remove(path)
        return self.windows, self.launches, summary


def _overlaps(a: float, b: float, intervals, into) -> float:
    """The length of [a, b] that the sorted, disjoint ``intervals``
    (start, end, name) cover, added to ``into[name]`` (µs → s) when
    given."""
    total = 0.0
    k = bisect.bisect_left(intervals, (b,)) - 1
    while k >= 0 and intervals[k][1] > a:
        lo, hi, name = intervals[k]
        part = min(b, hi) - max(a, lo)
        if part > 0:
            total += part
            if into is not None:
                into[name] += part * 1e-6
        k -= 1
    return total


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class TraceSummary:
    """The measured window of one trace, times in seconds."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        wins = [e for e in spans if e.get("name") == WINDOW
                and e.get("cat") == "user_annotation"]
        if not wins:
            raise RuntimeError("the trace holds no measured window")
        w0 = min(e["ts"] for e in wins)
        w1 = max(e["ts"] + e["dur"] for e in wins)
        self.window_s = (w1 - w0) * 1e-6
        self.device = [(e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in spans if e.get("cat") in DEVICE_CATS
                       and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
        busy = _union([(max(a, w0), min(b, w1)) for a, b, _ in self.device])
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        # The device's idle time inside the window, split by the stage
        # the host had open (the program's stages follow one another).
        stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                        for e in spans if e.get("cat") == "user_annotation"
                        and e.get("name") != WINDOW)
        win_iv = sorted((e["ts"], e["ts"] + e["dur"], "") for e in wins)
        idle = collections.defaultdict(float)
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            in_stages = _overlaps(a, b, stages, idle)
            in_windows = _overlaps(a, b, win_iv, None)
            idle["window, outside the program's stages"] += (
                in_windows - in_stages) * 1e-6
            idle["between windows"] += (b - a - in_windows) * 1e-6
        self.idle_by_label = dict(idle)
        self.stage_s = collections.defaultdict(float)
        for a, b, name in stages:
            self.stage_s[name] += (b - a) * 1e-6

    def kernel_s(self, substrings) -> float:
        """Device seconds of the kernels whose name holds one of
        ``substrings``."""
        return sum(b - a for a, b, name in self.device
                   if any(s in name for s in substrings)) * 1e-6

    def device_ops(self, k: int = 10) -> List[list]:
        by = collections.defaultdict(float)
        for a, b, name in self.device:
            by[name[:120]] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        return [[n, s] for n, s in sorted(self.idle_by_label.items(),
                                          key=lambda x: -x[1])[:k]]
