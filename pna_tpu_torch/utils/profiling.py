"""Profiling and tracing.

Counterpart of ``pna_tpu/utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` context (CPU and, where there is a
  card, CUDA activity) that writes a Chrome trace, ``trace.json``, into
  ``logdir`` on exit; ``op_times`` reads its device kernels and host
  operations per step;
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

import contextlib
import os
import time
from typing import List, Optional, Tuple

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


def debug_nans(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
