"""Profiling and tracing.

Counterpart of ``pna_tpu/utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` context (CPU and, where there is a
  card, CUDA activity) that writes a Chrome trace, ``trace.json``, into
  ``logdir`` on exit; ``op_times`` reads its device kernels and host
  operations per step;
* ``span(name, device)``: the program's named spans (``pna.*``), on one
  registry for the process (``span_stats``, ``span_seconds``,
  ``reset_spans``).  A span always takes the host clock; while the torch
  profiler runs it is also a ``record_function`` range, so that the trace
  names the time under it, and a span given a CUDA device times its work
  on the device with a pair of CUDA events;
* ``StepTimer``: steps/s and edges/s of steps timed on the host clock, each
  stop synchronised with the device the step's result lives on (the JAX
  ``block_until_ready``); the large-graph trainer times its steps with it;
* ``debug_nans``: ``torch.autograd.set_detect_anomaly``.  It differs from
  the JAX ``jax_debug_nans``: JAX checks every primitive's output in the
  forward and raises where a NaN appears; anomaly mode raises in the
  backward, at the first function whose gradient is NaN, and names the
  forward operation that made it (it also slows every step).
"""

from __future__ import annotations

import collections
import contextlib
import os
import statistics
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block and yield the profiler (``op_times`` reads it);
    with a ``logdir``, write ``<logdir>/trace.json`` on exit."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


Row = Tuple[str, float, int]


def op_times(prof, steps: int = 1) -> Tuple[List[Row], List[Row]]:
    """(device kernels, host operations) of a ``trace``, each a list of
    (name, ms per step, calls per step), longest first.  Device rows are
    the kernels' own time (a ``record_function`` range, which shows on
    the device too, is left out); host rows are self CPU time."""
    device, host = [], []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if (str(ev.device_type).endswith("CUDA") and us > 0
                and not getattr(ev, "is_user_annotation", False)):
            device.append((ev.key, us / steps / 1e3, ev.count // steps))
        elif ev.self_cpu_time_total > 0:
            host.append((ev.key, ev.self_cpu_time_total / steps / 1e3,
                         ev.count // steps))
    device.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    return device, host


def _synchronize(result) -> None:
    """Wait for the device of the first tensor in ``result``."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
        return
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for r in result:
            if isinstance(r, (torch.Tensor, list, tuple, dict)):
                _synchronize(r)
                return


class StepTimer:
    """Times steps on the host clock, waiting for the result's device at
    each stop; reports steps/s and, given the edges of a step, edges/s."""

    def __init__(self, edges_per_step: Optional[int] = None):
        self.edges_per_step = edges_per_step
        self.reset()

    def reset(self):
        self._t0 = None
        self.steps = 0
        self.elapsed = 0.0
        self.last = 0.0              # seconds of the latest step

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            _synchronize(result)
        self.last = time.perf_counter() - self._t0
        self.elapsed += self.last
        self.steps += 1

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.elapsed if self.elapsed else 0.0

    @property
    def edges_per_sec(self) -> float:
        if not self.edges_per_step:
            return 0.0
        return self.steps_per_sec * self.edges_per_step


# -- spans ------------------------------------------------------------------

RING = 4096           # host durations kept per span name, for its median


class _Stat:
    __slots__ = ('calls', 'total_ns', 'ring', 'events', 'device_ms',
                 'device_calls')

    def __init__(self):
        self.calls = 0
        self.total_ns = 0
        self.ring: Deque[int] = collections.deque(maxlen=RING)
        self.events: Deque[tuple] = collections.deque()   # (start, end)
        self.device_ms = 0.0
        self.device_calls = 0

    def read_events(self) -> None:
        """Add the device time of the recorded event pairs, waiting for the
        device where it has not passed them."""
        while self.events:
            start, end = self.events.popleft()
            end.synchronize()
            self.device_ms += start.elapsed_time(end)
            self.device_calls += 1


_SPANS: Dict[str, _Stat] = {}
_tracing = torch._C._autograd._profiler_enabled


class span:
    """``with span(name, device):`` a named span of the program.

    Always: ``time.perf_counter_ns`` at enter and exit; the registry keeps
    per name the calls, their total and the last ``RING`` durations.  While
    the torch profiler runs (``trace``, or any ``torch.profiler.profile``):
    a ``torch.profiler.record_function(name)`` range around the block, and,
    where ``device`` is a CUDA device, a pair of timing events on its
    current stream, read into device time only by ``span_stats``.  It
    touches no tensor and no random state."""

    __slots__ = ('name', 'device', '_t0', '_range', '_start')

    def __init__(self, name: str, device=False):
        self.name = name
        self.device = device          # False, or the torch.device it runs on

    def __enter__(self):
        self._range = self._start = None
        if _tracing():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            if self.device and self.device.type == 'cuda':
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record(torch.cuda.current_stream(self.device))
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        st = _SPANS.get(self.name)
        if st is None:
            st = _SPANS.setdefault(self.name, _Stat())
        st.calls += 1
        st.total_ns += dt
        st.ring.append(dt)
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            st.events.append((self._start, end))
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span_stats() -> Dict[str, dict]:
    """Per span name: ``calls``, host seconds in all (``host_s``) and the
    median of the last ``RING`` calls (``host_median_s``), device seconds
    (``device_s``) of the ``device_calls`` timed on a CUDA device, those
    made while the profiler ran.  Waits for the device where a timed span
    is still running there."""
    out = {}
    for name, st in list(_SPANS.items()):
        st.read_events()
        out[name] = dict(calls=st.calls, host_s=st.total_ns / 1e9,
                         host_median_s=statistics.median(st.ring) / 1e9,
                         device_s=st.device_ms / 1e3,
                         device_calls=st.device_calls)
    return out


def span_seconds(since: Optional[Dict[str, float]] = None
                 ) -> Dict[str, float]:
    """Host seconds per span name over the process's calls; with
    ``since``, an earlier return, over the calls made after it."""
    since = since or {}
    return {name: st.total_ns / 1e9 - since.get(name, 0.0)
            for name, st in list(_SPANS.items())}


def reset_spans() -> None:
    """Forget every span (for tests)."""
    _SPANS.clear()


def debug_nans(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
