"""The metrics that read the program's spans
(``pna_tpu_torch/utils/profiling.py::span_stats``): each is None with no
span, and a number with one: the ZINC ones the median host milliseconds
(None off the card), the large graph's the device milliseconds over the
traced steps (None where the span was never timed on the device, or
nothing was traced)."""

from types import SimpleNamespace

import pytest
import torch

from portbench import spec

HOST = {'h2d_ms_per_step': 'pna.h2d',
        'forward_host_ms_per_step': 'pna.forward',
        'backward_host_ms_per_step': 'pna.backward',
        'optimizer_host_ms_per_step': 'pna.optimizer'}
DEVICE = {'forward_device_ms_per_step': 'pna.forward',
          'backward_device_ms_per_step': 'pna.backward',
          'message_device_ms_per_step': 'pna.message',
          'aggregate_device_ms_per_step': 'pna.aggregate',
          'update_device_ms_per_step': 'pna.update'}


@pytest.fixture
def profiling():
    from pna_tpu_torch.utils import profiling
    profiling.reset_spans()
    yield profiling
    profiling.reset_spans()


def _ctx(steps=5, device='cuda'):
    return SimpleNamespace(trace=SimpleNamespace(steps=steps),
                           driver=SimpleNamespace(
                               device=torch.device(device)))


def test_every_span_metric_is_declared():
    named = {m['name']: m for m in spec.load_benchmark()['per_layer']}
    for name in {**HOST, **DEVICE}:
        assert named[name]['source'] == 'program_span'
        assert named[name]['unit'] == 'ms'


@pytest.mark.parametrize('metric', sorted({**HOST, **DEVICE}))
def test_none_without_the_span(profiling, metric):
    with profiling.span('pna.other'):
        pass
    assert spec.load_metric(metric).read(_ctx()) is None


@pytest.mark.parametrize('metric', sorted(HOST))
def test_host_median_with_the_span(profiling, monkeypatch, metric):
    ticks = iter([0, 2_000_000, 0, 4_000_000, 0, 9_000_000])
    monkeypatch.setattr(profiling.time, 'perf_counter_ns',
                        lambda: next(ticks))
    for _ in range(3):
        with profiling.span(HOST[metric]):
            pass
    read = spec.load_metric(metric).read
    assert read(_ctx()) == pytest.approx(4.0)
    assert read(_ctx(device='cpu')) is None     # the CPU's work


@pytest.mark.parametrize('metric', sorted(DEVICE))
def test_device_ms_per_traced_step_with_the_span(profiling, monkeypatch,
                                                  metric):
    read = spec.load_metric(metric).read
    with profiling.span(DEVICE[metric]):
        pass
    assert read(_ctx()) is None                  # never timed on the device
    stats = {DEVICE[metric]: dict(calls=20, host_s=1.0, host_median_s=0.05,
                                  device_s=0.75, device_calls=20)}
    monkeypatch.setattr(profiling, 'span_stats', lambda: stats)
    assert read(_ctx(steps=5)) == pytest.approx(150.0)
    assert read(SimpleNamespace(trace=None)) is None
    assert read(_ctx(steps=0)) is None
