"""The GAT cell and the uniform large-graph cell on the CPU at small sizes:
the driver against the plain reference, its readings from the seed, the
labels' frozen copy, the counts behind the new metrics, and the refusal of
a program without the GAT net."""

import copy

import numpy as np
import pytest

from portbench import counts_gat, gat_inputs, spec
from portbench.reference import gat as ref
from portbench.run import run_cell

GAT = 'largegraph_gat.powerlaw_6m'
UNIFORM = 'largegraph_pna.uniform_6m'


def small_gat(root=spec.ROOT):
    """The GAT cell at 2,000 nodes, 20,000 edges and heads of 16, 16 and 5
    (a 5-label output): its driver, reference and comparison as they are."""
    cell = spec.load_cell(GAT, root)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config.update(num_nodes=2000, num_edges=20000, label_dim=5)
    cell.config['net_params'].update(head_dim=[16, 16, 5])
    cell.traffic.update(warmup_steps=0, traced_steps=2)
    return cell


def small_uniform():
    cell = spec.load_cell(UNIFORM)
    cell.config = dict(cell.config, num_nodes=3000, num_edges=30000)
    cell.traffic = dict(cell.traffic, warmup_steps=0, traced_steps=2)
    return cell


@pytest.mark.parametrize('make', [small_gat, small_uniform])
def test_small_run_is_correct(make):
    r, _ = run_cell(make(), 2 ** 31 + 41, 0.2, True, 'cpu', 0.0)
    assert r['correct'], r['checks']
    assert r['attempted'] > 0 and r['failed'] == 0
    assert list(r)[-1] == 'checks'
    # a CPU run reads no device metric
    assert r['metrics'] == {}


def test_gat_end_to_end_metrics_from_a_window():
    r, w = run_cell(small_gat(), 7, 0.3, False, 'cpu', 0.0)
    m = r['metrics']
    assert set(m) == {'train_edges_per_s.full_graph', 'step_ms_p90',
                      'setup_s'}
    assert w['work_edges'] == w['steps'] * 20000 * 3


def test_gat_same_seed_same_readings():
    import torch
    drivers = []
    for _ in range(2):
        cell = small_gat()
        d = spec.load_driver(cell.traffic['driver']).Driver(cell, 'cpu')
        d.setup(2 ** 33 + 5)
        drivers.append(d)
    a, b = drivers
    assert a.program_readings == b.program_readings
    for k, v in a.weights.items():
        assert torch.equal(v, b.weights[k])
    assert sorted(a.weights) == sorted(n for n, _, _ in ref.param_spec(a.net))


def test_labels_are_the_programs():
    """The frozen copy draws what the program's trainer draws."""
    from pna_tpu_torch.train.largegraph import neighbor_mean_labels
    rng = np.random.RandomState(0)
    send, recv = rng.randint(0, 500, 4000), rng.randint(0, 500, 4000)
    x = rng.randn(500, 50).astype(np.float32)
    a = gat_inputs.neighbor_mean_labels(send, recv, x, 500, 121, 9)
    assert np.array_equal(a, neighbor_mean_labels(send, recv, x, 500, 121, 9))
    assert a.shape == (500, 121) and 0.2 < a.mean() < 0.8


def test_counts_at_the_cell():
    """The cell's step: ~11 TFLOP, the projections and the skip connection
    nearly all of it; the attention's lower bounds in bytes."""
    net = ref.net_of(spec.load_cell(GAT).config)
    n, e = 625_000, 6_250_000
    flops = counts_gat.step_flops(net, n, e)
    assert 10.5e12 < flops < 11.5e12
    wide = counts_gat.attend_bytes(n, n, e, 4, 256)
    assert 5.1e9 < wide < 5.2e9          # hw read, out written: 2 x 2.56 GB
    # hw, out and d_out read, d_hw written
    assert 10.24e9 < counts_gat.attend_bwd_bytes(n, n, e, 4, 256) < 10.4e9


def test_program_without_gat_fails_at_once(monkeypatch):
    """A program without the GAT net (an older one) makes set-up raise
    before any input is drawn."""
    import builtins
    real = builtins.__import__

    def no_gat(name, *args, **kw):
        mod = real(name, *args, **kw)
        if name == 'pna_tpu_torch.parallel.distributed_net' and \
                'DistributedGATNet' in (args[2] if len(args) > 2 else ()):
            raise ImportError("cannot import name 'DistributedGATNet'")
        return mod

    monkeypatch.setattr(builtins, '__import__', no_gat)
    cell = small_gat()
    d = spec.load_driver(cell.traffic['driver']).Driver(cell, 'cpu')
    with pytest.raises(RuntimeError, match='no GAT net'):
        d.setup(3)
    assert not hasattr(d, 'inputs')


class _Trace:
    def __init__(self, kernels, steps=2, window_s=1.0):
        self.kernels, self.steps, self.window_s = kernels, steps, window_s

    def kernel_time(self, patterns):
        n = s = 0
        for name, (c, t) in self.kernels.items():
            if any(p in name for p in patterns):
                n, s = n + c, s + t
        return n, s


def test_roofline_readers():
    from portbench import peaks
    from portbench.run import Context
    cell = spec.load_cell(GAT)

    class D:
        net = ref.net_of(cell.config)
        traced_work = dict(nodes=2 * 625_000, edges=2 * 6_250_000, graphs=0)

        def attention_shapes(self):
            return [dict(nodes=625_000, table=625_000, edges=6_250_000,
                         heads=d['heads'], f=d['f'])
                    for d in ref.layer_dims(self.net)]

    trace = _Trace({
        'void gat_attend_fwd_kernel<8, 4>': (4, 0.014),
        'void gat_attend_fwd_kernel<4, 8>': (2, 0.016),
        'void gat_attend_bwd_recv_kernel<8, 4>': (6, 0.03),
        'void gat_attend_bwd_send_kernel<8, 4>': (6, 0.06),
        'void gat_attend_merge_runs_kernel<8, 4>': (6, 0.003),
        'void gat_attend_merge_final_kernel<8, 4>': (6, 0.001)})
    ctx = Context(cell=cell, driver=D(), window={}, setup_s=1.0,
                  window_peak_bytes=None, trace=trace,
                  peak=peaks.peak('NVIDIA H100 80GB HBM3'))
    fwd = spec.load_metric('gat_attend_roofline').read(ctx)
    bwd = spec.load_metric('gat_attend_bwd_roofline').read(ctx)
    assert 0 < fwd < 100 and 0 < bwd < 100
    mfu = spec.load_metric('step_mfu.gat_full_graph').read(ctx)
    assert mfu == pytest.approx(100 * counts_gat.step_flops(
        D.net, 2 * 625_000, 2 * 6_250_000) / 1.0 / 67e12)
    # without the kernels, or a count that is not a whole number of steps
    for kernels in ({}, {'void gat_attend_fwd_kernel<8, 4>': (4, 0.01)}):
        ctx.trace = _Trace(kernels)
        assert spec.load_metric('gat_attend_roofline').read(ctx) is None
