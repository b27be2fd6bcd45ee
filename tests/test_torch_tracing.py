"""The program's spans (``pna_tpu_torch/utils/profiling.py::span``) on the
CPU: the registry's counts, totals and ring medians; no profiler range and
no CUDA event while the profiler is off; under ``torch.profiler.profile``
the trainer's and the layer's spans as nested host events, the layer's
phases once per layer per step; ``run_epoch``'s ``last_pass`` as the
registry's sums over its pass; a checkpointed layer's replay inside the
backward left out of the phases; the device path with stand-in CUDA
events; and a run's numbers bit-equal with and without the profiler.
The card's twin is in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from pna_tpu_torch.data import molecules as tmol
from pna_tpu_torch.nn.nets import PNANetMolecules
from pna_tpu_torch.train import realworld as trw
from pna_tpu_torch.utils import profiling

AGGS = ('mean', 'max', 'min', 'std')
SCAL = ('identity', 'amplification', 'attenuation')
NET = dict(hidden_dim=16, out_dim=16, n_layers=2, aggregators=AGGS,
           scalers=SCAL, readout_type='sum', towers=2,
           divide_input_first=False, divide_input_last=True, graph_norm=True,
           batch_norm=True, residual=True, edge_feat=True, edge_dim=8,
           dropout=0.1)
STEP = ('pna.collate', 'pna.h2d', 'pna.forward', 'pna.backward',
        'pna.optimizer', 'pna.loss_read')
PHASES = ('pna.message', 'pna.aggregate', 'pna.update')


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _trainer(remat=False):
    ds = tmol.ZincDataset.synthetic(n_train=16, n_val=4, n_test=4, seed=0)
    model = PNANetMolecules(num_atom_type=28, num_bond_type=4,
                            avg_d=ds.avg_d(), device='cpu', seed=3,
                            remat=remat, **NET)
    trainer = trw.RealworldTrainer(
        model, PNANetMolecules.loss, trw.PipelineConfig(batch_size=8),
        forward_args=lambda g: (g, g.node_feats.squeeze(-1),
                                g.edge_feats.squeeze(-1)),
        device='cpu')
    return trainer, ds


def _clock(monkeypatch, durations):
    """perf_counter_ns stand-in: each span's enter and exit read 0 and its
    duration."""
    ticks = iter([t for d in durations for t in (0, d)])
    monkeypatch.setattr(profiling.time, 'perf_counter_ns',
                        lambda: next(ticks))


def test_span_counts_totals_and_ring_median(monkeypatch):
    monkeypatch.setattr(profiling, 'RING', 4)
    durations = [5_000, 1_000, 9_000, 3_000, 7_000, 2_000]
    _clock(monkeypatch, durations)
    for _ in durations:
        with profiling.span('pna.test'):
            pass
    s = profiling.span_stats()['pna.test']
    assert s['calls'] == 6
    assert s['host_s'] == sum(durations) / 1e9
    # the median of the last RING calls: 9, 3, 7, 2 us
    assert s['host_median_s'] == 5_000 / 1e9
    assert s['device_s'] == 0.0 and s['device_calls'] == 0
    assert profiling.span_seconds() == {'pna.test': sum(durations) / 1e9}


def test_span_seconds_since_and_reset():
    with profiling.span('pna.a'):
        pass
    before = profiling.span_seconds()
    with profiling.span('pna.b'):
        pass
    after = profiling.span_seconds(before)
    assert after['pna.a'] == 0.0 and after['pna.b'] > 0.0
    profiling.reset_spans()
    assert profiling.span_stats() == {} and profiling.span_seconds() == {}


def test_span_reraises_and_still_records():
    with pytest.raises(KeyError):
        with profiling.span('pna.fails'):
            raise KeyError('x')
    assert profiling.span_stats()['pna.fails']['calls'] == 1


class _Event:
    """torch.cuda.Event stand-in: an event pair reads 2.5 ms."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.done = False

    def record(self, stream=None):
        self.stream = stream

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert end.done
        return 2.5


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA events and streams stood in for, so that the device path of a
    span runs on the CPU; and every record_function range counted."""
    _Event.made = 0
    ranges = []
    real = torch.profiler.record_function

    def counted(name):
        ranges.append(name)
        return real(name)

    monkeypatch.setattr(torch.cuda, 'Event', _Event)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: ('stream', device))
    monkeypatch.setattr(torch.profiler, 'record_function', counted)
    return ranges


def test_no_range_and_no_event_while_tracing_is_off(fake_cuda):
    card = torch.device('cuda')
    for name in ('pna.forward', 'pna.h2d'):
        with profiling.span(name, card):
            pass
    assert fake_cuda == [] and _Event.made == 0
    s = profiling.span_stats()
    assert s['pna.forward']['calls'] == 1
    assert s['pna.forward']['device_calls'] == 0
    assert s['pna.forward']['device_s'] == 0.0


def test_device_time_read_from_event_pairs_while_tracing(fake_cuda):
    card = torch.device('cuda', 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span('pna.forward', card):
                with profiling.span('pna.h2d'):
                    pass
        with profiling.span('pna.update', torch.device('cpu')):
            pass
    assert fake_cuda == ['pna.forward', 'pna.h2d'] * 3 + ['pna.update']
    assert _Event.made == 6           # a pair per span on the card
    pending = profiling._SPANS['pna.forward'].events
    assert len(pending) == 3 and pending[0][0].stream == ('stream', card)
    s = profiling.span_stats()
    assert pending == type(pending)()      # read, and let go
    assert s['pna.forward']['device_calls'] == 3
    assert s['pna.forward']['device_s'] == pytest.approx(3 * 2.5e-3)
    assert s['pna.h2d']['device_calls'] == 0
    assert s['pna.update']['device_calls'] == 0


def _host_events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith('pna.')
            and 'CUDA' not in str(e.device_type())]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_profiler_names_the_spans_nested(monkeypatch):
    trainer, ds = _trainer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.run_epoch(ds.train, True, 1)
    ev = _host_events(prof)
    names = [e[0] for e in ev]
    steps = trainer.last_pass['steps']
    assert steps == 2
    for name in STEP[1:]:
        assert names.count(name) == steps, name
    assert names.count('pna.collate') == steps + 1      # the last finds none
    assert names.count('pna.epoch_metric') == 1
    forwards = [e for e in ev if e[0] == 'pna.forward']
    for name in PHASES:
        phases = [e for e in ev if e[0] == name]
        assert len(phases) == NET['n_layers'] * steps, name
        # each step's forward holds each phase once per layer
        for f in forwards:
            assert sum(_inside(p, f) for p in phases) == NET['n_layers']


def test_last_pass_is_the_registry_over_the_pass():
    trainer, ds = _trainer()
    trainer.run_epoch(ds.train, True, 1)          # spans from before
    before = profiling.span_seconds()
    calls = {k: v['calls'] for k, v in profiling.span_stats().items()}
    trainer.run_epoch(ds.train, True, 2)
    spent = profiling.span_seconds(before)
    lp = trainer.last_pass
    assert set(lp) == {'seconds', 'steps', 'collate_s', 'h2d_s',
                       'forward_s', 'backward_s', 'optimizer_s', 'sync_s'}
    for key, name in trw.PASS_SPANS.items():
        assert lp[key] == spent[name] and lp[key] > 0.0, key
    assert sum(lp[k] for k in trw.PASS_SPANS) <= lp['seconds']
    after = profiling.span_stats()
    for name in STEP[1:]:
        assert after[name]['calls'] - calls[name] == lp['steps'], name
    # an evaluation pass has no backward or optimizer
    trainer.run_epoch(ds.val, False, 0)
    assert trainer.last_pass['backward_s'] == 0.0
    assert trainer.last_pass['optimizer_s'] == 0.0
    assert trainer.last_pass['forward_s'] > 0.0


def test_fit_history_carries_the_span_sums():
    trainer, ds = _trainer()
    _, _, hist = trainer.fit(ds, log_fn=lambda s: None, epochs=1)
    h = hist[0]
    for key in trw.PASS_SPANS:
        assert 0.0 < h[key] <= h['train_s'], key


def test_remat_replay_left_out_of_the_phases():
    """Under remat each layer's forward runs again inside the backward;
    its phases are not spans there: the backward's time holds them."""
    trainer, ds = _trainer(remat=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.run_epoch(ds.train[:8], True, 1)
    ev = _host_events(prof)
    backward = [e for e in ev if e[0] == 'pna.backward']
    forward = [e for e in ev if e[0] == 'pna.forward']
    assert len(backward) == len(forward) == 1
    for name in PHASES:
        phases = [e for e in ev if e[0] == name]
        assert len(phases) == NET['n_layers'], name
        assert all(_inside(p, forward[0]) for p in phases)
        assert not any(_inside(p, backward[0]) for p in phases)
        assert profiling.span_stats()[name]['calls'] == NET['n_layers']


def _two_steps(profile: bool):
    torch.manual_seed(0)
    trainer, ds = _trainer()
    if profile:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            loss, metric = trainer.run_epoch(ds.train, True, 1)
    else:
        loss, metric = trainer.run_epoch(ds.train, True, 1)
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    return loss, metric, state, trainer.model.generator.get_state()


def test_two_steps_bit_equal_with_and_without_the_profiler():
    a, b = _two_steps(False), _two_steps(True)
    assert a[0] == b[0] and a[1] == b[1]
    assert a[2].keys() == b[2].keys()
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k
    assert torch.equal(a[3], b[3])


def test_largegraph_step_spans():
    """The large-graph step's phases and its layers' phases, once each a
    step, nested in the forward."""
    from pna_tpu_torch.parallel.distributed_net import DistributedPNANet
    from pna_tpu_torch.parallel.partition import (partition_edges,
                                                  powerlaw_graph,
                                                  sort_partition_edges)
    from pna_tpu_torch.train.largegraph import make_node_train_step
    n, e = 200, 1200
    send, recv = powerlaw_graph(n, e, seed=1)
    part = sort_partition_edges(partition_edges(send, recv, n, 1))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(part.scatter_features(
        rng.randn(n, 6).astype(np.float32))[0])
    y = torch.from_numpy(rng.randn(*part.node_mask.shape).astype(
        np.float32)[0])
    mask = torch.from_numpy(part.node_mask[0])
    net = DistributedPNANet(6, hidden_dim=8, out_dim=8, n_layers=3,
                            towers=2, node_level=True, kernel='csr',
                            device='cpu', seed=0)
    step, _, _ = make_node_train_step(
        part, None, net, torch.optim.Adam(net.parameters(), lr=1e-3))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(x, y, mask)
    ev = _host_events(prof)
    names = [n for n, _, _ in ev]
    for name in ('pna.forward', 'pna.backward', 'pna.optimizer',
                 'pna.loss_read'):
        assert names.count(name) == 2, name
    forwards = [e for e in ev if e[0] == 'pna.forward']
    for name in PHASES:
        phases = [e for e in ev if e[0] == name]
        assert len(phases) == 3 * 2
        for f in forwards:
            assert sum(_inside(p, f) for p in phases) == 3
