"""A profiled stretch of steps and what the device did in it.

``profile(run)`` runs ``run()`` (which returns the number of steps it took
and ends on a host read of the step's result) under ``torch.profiler`` with
CPU and CUDA activity, inside one annotated range that closes after a
device synchronise.  The trace stays in memory.  ``Trace`` reads it:

* the window: the annotated range on the host clock;
* every device activity (kernels, copies, sets) clipped to the window; busy
  time is the length of their union;
* kernels by name (count and seconds);
* each idle gap of the device, named by the innermost host operation
  running at its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = 'portbench.traced_steps'
# host events that are not operations: the CUDA runtime and driver calls
# inside an operation, and annotations
_HOST_SKIP = ('runtime', 'driver', 'annotation')


def _ns(ev, what: str) -> int:
    if hasattr(ev, f'{what}_ns'):
        return int(getattr(ev, f'{what}_ns')())
    return int(getattr(ev, f'{what}_us')() * 1000)


def _activity(ev) -> str:
    return str(ev.activity_type()) if hasattr(ev, 'activity_type') else ''


def _is_driver_call(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernel``): the operation around it says more."""
    return name.startswith('cuda') or (name.startswith('cu')
                                       and name[2:3].isupper())


def _is_annotation(ev) -> bool:
    if hasattr(ev, 'is_user_annotation') and ev.is_user_annotation():
        return True
    return 'annotation' in _activity(ev).lower()


@dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]     # name -> (count, seconds)
    device_ops: Dict[str, float]              # every device activity
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    @property
    def n_kernels(self) -> int:
        return sum(c for c, _ in self.kernels.values())

    def kernel_time(self, patterns) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose names hold any of
        ``patterns``."""
        n = s = 0
        for name, (c, t) in self.kernels.items():
            if any(p in name for p in patterns):
                n, s = n + c, s + t
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        def rows(d):
            return [[k[:160], v] for k, v in sorted(
                d.items(), key=lambda kv: -kv[1])[:top]]
        return dict(device_ops=rows(self.device_ops),
                    idle_gaps=rows(self.idle_by_host))


def profile(run: Callable[[], int]) -> Trace:
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW):
            steps = run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return read(prof.profiler.kineto_results.events(), steps)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def read(events, steps: int) -> Trace:
    w0 = w1 = None
    device, host = [], []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    ops: Dict[str, float] = defaultdict(float)
    for ev in events:
        name = ev.name()
        start = _ns(ev, 'start')
        end = start + _ns(ev, 'duration')
        on_device = 'CUDA' in str(ev.device_type())
        if name == WINDOW and not on_device:
            w0, w1 = start, end
            continue
        if on_device:
            if _is_annotation(ev):
                continue
            device.append((start, end, name, _activity(ev)))
        elif not (any(k in _activity(ev).lower() for k in _HOST_SKIP)
                  or _is_driver_call(name)):
            host.append((start, end, name))
    if w0 is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    spans = []
    for start, end, name, act in device:
        a, b = max(start, w0), min(end, w1)
        if b <= a:
            continue
        spans.append((a, b))
        ops[name] += (b - a) / 1e9
        is_copy = ('memcpy' in act.lower() or 'memset' in act.lower()
                   or name.startswith(('Memcpy', 'Memset')))
        if not is_copy:
            kernels[name][0] += 1
            kernels[name][1] += (b - a) / 1e9
    busy = _union(spans)
    idle = _idle_by_host(busy, w0, w1, host)
    return Trace(steps=steps, window_s=(w1 - w0) / 1e9,
                 busy_s=sum(b - a for a, b in busy) / 1e9,
                 kernels={k: (int(c), t) for k, (c, t) in kernels.items()},
                 device_ops=dict(ops), idle_by_host=idle)


def _idle_by_host(busy, w0: int, w1: int, host, walk: int = 256
                  ) -> Dict[str, float]:
    """Seconds of device idleness by the innermost host operation running
    at the middle of each gap."""
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    starts = [h[0] for h in host]
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = 'outside any host operation'
        for j in range(i, max(i - walk, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] += (b - a) / 1e9
    return dict(out)
