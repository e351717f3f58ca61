"""The traced run's readings: spans on the host clock, and the profiler's
device activity over the window.

:class:`Recorder` keeps each span the harness and the drivers open in
memory (name, start, end on ``time.perf_counter``). The profiler records
the device's activity alone (CUPTI: kernels, copies, sets; no host ops,
whose recording slows the host-paced plan build by half), on the Unix
clock, onto which the spans are carried by one offset taken when the
recorder starts. :func:`summarize` reads the events once the window has
closed: the device's busy time (the union of its activity), each
kernel's time, and the idle gaps, each put down to the innermost span
the host was in at its middle.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import NamedTuple

import torch

WINDOW = "window"


class Recorder:
    def __init__(self):
        self.spans: list = []
        self.unix_offset_ns = time.time_ns() - time.perf_counter_ns()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def unix_ns(self, t: float) -> int:
        return int(t * 1e9) + self.unix_offset_ns


class Trace(NamedTuple):
    busy_s: float
    window_s: float
    kernels: dict      # device op name -> seconds over the window
    idle_by_host: dict  # innermost host span at an idle gap -> seconds


class Profiler:
    """The profiler's own switch, without ``torch.profiler.profile``'s
    parse of every event into Python objects when it stops (a minute for
    a window of MinkUNet requests); :meth:`events` gives kineto's raw
    events."""

    def __init__(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, _enable_profiler,
                                    _prepare_profiler)
        self.config = ProfilerConfig(ProfilerState.KINETO, False, False,
                                     False, False, False,
                                     _ExperimentalConfig())
        self.activities = {ProfilerActivity.CUDA
                           if torch.cuda.is_available()
                           else ProfilerActivity.CPU}
        _prepare_profiler(self.config, self.activities)
        _enable_profiler(self.config, self.activities)
        self.result = None

    def stop(self) -> None:
        from torch.autograd import _disable_profiler
        self.result = _disable_profiler()

    def events(self):
        return self.result.events()


def start() -> Profiler:
    return Profiler()


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, rec: Recorder) -> Trace:
    """The device's activity inside the recorder's window span."""
    cuda = torch.autograd.DeviceType.CUDA
    device = []
    for e in prof.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        s = e.start_ns()
        device.append((s, s + e.duration_ns(), e.name()))
    host, window = [], None
    for name, t0, t1 in rec.spans:
        span = (rec.unix_ns(t0), rec.unix_ns(t1), name)
        if name == WINDOW:
            window = span
        else:
            host.append(span)
    if window is None:
        raise RuntimeError("the recorder holds no window span")
    w0, w1 = window[0], window[1]
    kernels = defaultdict(float)
    clipped = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e))
            kernels[name] += (e - s) * 1e-9
    busy = _union(clipped)
    idle = defaultdict(float)
    host.sort()
    starts = [h[0] for h in host]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            idle[_innermost(host, starts, (g0 + g1) // 2)] += (g1 - g0) * 1e-9
    return Trace(sum(e - s for s, e in busy) * 1e-9, (w1 - w0) * 1e-9,
                 dict(kernels), dict(idle))


def _innermost(host: list, starts: list, t: int) -> str:
    """The name of the latest-starting span that holds time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if host[i][1] > t:
            return host[i][2]
        i -= 1
    return "outside spans"


def seconds_matching(trace: Trace, patterns) -> float:
    """Device seconds of the ops whose names hold one of ``patterns``."""
    return sum(t for name, t in trace.kernels.items()
               if any(p in name for p in patterns))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device ops that took most time
    and the idle time by what the host was doing, each [name, seconds]."""
    def head(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": head(trace.kernels),
            "idle_gaps": head(trace.idle_by_host)}
