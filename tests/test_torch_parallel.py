"""Tower tensor parallelism, the multitask engine's data parallelism and the
profiling helpers of the port, against pna_tpu.

* Tower TP: ``PNALayerFused(tp_group=...)`` over four spawned gloo ranks at
  tp 2 and 4 against the JAX single-device layer (``tests/test_tower_tp.py``'s
  graph, layer and tolerances: output rtol/atol 2e-5, loss rtol 1e-5,
  gradients rtol 5e-4, atol 5e-5), each tower's gradient read from the rank
  that holds it.
* ``MultitaskTrainer(data_parallel=True)`` over two spawned gloo ranks, one
  Adam step on the first train bucket (32 graphs, 16 on each rank),
  against the JAX trainer's step on one device: the loss, the weights and
  the batch-norm statistics within the single-rank test's rtol 2e-4 (atol
  2e-5), the pre-norm readout biases left out of training in both, as
  there.
* ``utils/profiling.py``: ``StepTimer``'s counts and rates, and ``trace``
  writing a Chrome trace.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu.data import multitask as jmt
from pna_tpu.graph import batch_graphs as jbatch_graphs
from pna_tpu.nn import dense as jd
from pna_tpu.nn import gnn as jgnn
from pna_tpu.nn.fused import PNALayerFused as JLayer
from pna_tpu.ops import scalers as jsc
from pna_tpu.train import engine as jeng
from pna_tpu_torch.nn import dense as td
from pna_tpu_torch.nn import gnn as tgnn
from pna_tpu_torch.parallel import tower_tp
from pna_tpu_torch.utils import profiling
from pna_tpu_torch.weights import from_jax

from tests import _torch_dist_ranks as ranks
from tests.test_torch_multitask import _freeze_pre_norm, _gnn_kw, _np

AGGS = ('mean', 'max', 'min', 'std')
SCAL = ('identity', 'amplification', 'attenuation')
AVG_D = {"lin": 3.0, "log": 1.1}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch's ops in this process run on one thread: beside other test
    workers and the spawned ranks, its thread pool would wait on threads the
    system has put to sleep."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

def _records(seed=0, n=14):
    """tests/test_tower_tp.py's graph."""
    rng = np.random.RandomState(seed)
    adj = (rng.rand(n, n) < 0.4).astype(np.float32)
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0)
    for i in range(n):
        if adj[i].sum() == 0:
            j = (i + 1) % n
            adj[i, j] = adj[j, i] = 1
    recv, send = np.nonzero(adj)
    feats = rng.randn(n, 16).astype(np.float32)
    return [dict(node_feats=feats, senders=send.astype(np.int32),
                 receivers=recv.astype(np.int32))]


def test_tower_tp_matches_single_device(tmp_path):
    records = _records()
    graph = jbatch_graphs(records)
    h = jnp.asarray(graph.node_feats)
    base = JLayer(out_dim=16, aggregators=AGGS, scalers=SCAL, avg_d=AVG_D,
                  towers=4, divide_input=True, batch_norm=False,
                  residual=True)
    params = jax.jit(lambda: base.init({'params': jax.random.PRNGKey(0)},
                                       graph, h, train=False))()['params']

    def f(p):
        out = base.apply({'params': p}, graph, h, train=False)
        return jnp.sum(out * out), out

    (ref_loss, ref_out), ref_grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    state = from_jax(_np(params))
    specs = tower_tp.tower_param_specs(state)
    assert sum(specs.values()) == 4            # pretrans and posttrans
    layer_kw = dict(in_dim=16, out_dim=16, aggregators=AGGS, scalers=SCAL,
                    avg_d=AVG_D, towers=4, divide_input=True,
                    batch_norm=False, residual=True, kernel='generic')
    res = ranks.run_world('tower_tp_ranks', 4, tmp_path, layer_kw, state,
                          records)
    want = {k: v.numpy() for k, v in from_jax(_np(ref_grads)).items()}
    for tp in (2, 4):
        for r in range(4):
            got = res[r][tp]
            np.testing.assert_allclose(got['out'].numpy()[:len(ref_out)],
                                       np.asarray(ref_out), rtol=2e-5,
                                       atol=2e-5)
            np.testing.assert_allclose(got['loss'], float(ref_loss),
                                       rtol=1e-5)
        group = range(tp)              # the group of rank 0
        for k, w in want.items():
            if specs[k]:
                g = np.concatenate([res[r][tp]['grads'][k].numpy()
                                    for r in group])
            else:
                g = res[0][tp]['grads'][k].numpy()
            np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-5,
                                       err_msg=f"tp {tp} {k}")


def test_multitask_data_parallel_matches_jax(tmp_path):
    jdata = jmt.load_multitask_dataset('synthetic', print_baseline=False)
    avg_d = jsc.avg_d_from_dense_adj(jdata['adj']['train'])
    cfg = dict(lr=0.003, weight_decay=1e-6)
    jtrainer = jeng.MultitaskTrainer(jgnn.GNN(**_gnn_kw(jd, avg_d)), jdata,
                                     jeng.TrainConfig(**cfg, seed=5))
    model = tgnn.GNN(in_features=2, device='cpu', seed=0,
                     **_gnn_kw(td, avg_d))
    frozen = _freeze_pre_norm(jtrainer, model)
    # init_state's draw, jitted
    x0 = jnp.asarray(jdata['features']['train'][0][:2])
    a0 = jnp.asarray(jdata['adj']['train'][0][:2])
    v = jax.jit(lambda: jtrainer.model.init(
        {'params': jax.random.PRNGKey(5)}, x0, a0, train=False))()
    state = dict(params=v['params'], batch_stats=v['batch_stats'],
                 opt_state=jtrainer.tx.init(v['params']),
                 rng=jax.random.PRNGKey(5))
    init = from_jax(_np(state['params']), _np(state['batch_stats']))
    bucket = [jnp.asarray(jdata[k]['train'][0]) for k in
              ('features', 'adj', 'node_labels', 'graph_labels')]
    params, stats, _, _, jloss = jtrainer._make_train_step()(
        state['params'], state['batch_stats'], state['opt_state'],
        state['rng'], *bucket)
    want = from_jax(_np(params), _np(stats))
    res = ranks.run_world('multitask_dp_ranks', 2, tmp_path,
                          _gnn_kw(td, avg_d), init, sorted(frozen), cfg)
    for r in res:
        np.testing.assert_allclose(r['loss'], float(jloss), rtol=2e-4)
        assert r['state'].keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(r['state'][k].numpy(), w.numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)


def test_step_timer_counts_steps_and_edges():
    timer = profiling.StepTimer(edges_per_step=1000)
    assert timer.steps_per_sec == 0.0 and timer.edges_per_sec == 0.0
    for _ in range(3):
        timer.start()
        x = torch.ones(64, 64) @ torch.ones(64, 64)
        timer.stop((x, {'y': x}))
        assert 0 < timer.last <= timer.elapsed
    assert timer.steps == 3 and timer.elapsed > 0
    assert timer.edges_per_sec == pytest.approx(
        1000 * timer.steps_per_sec)
    timer.reset()
    assert timer.steps == 0 and timer.elapsed == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.relu(torch.randn(32, 32)).sum()
    path = tmp_path / 'trace.json'
    assert path.exists()
    events = json.loads(path.read_text())['traceEvents']
    assert any('relu' in e.get('name', '') for e in events)
    assert prof.key_averages()


def test_op_times_reads_the_trace(tmp_path):
    """Host operations per step from a CPU trace, and no device rows; no
    file without a logdir."""
    with profiling.trace() as prof:
        for _ in range(2):
            torch.relu(torch.randn(32, 32)).sum()
    device, host = profiling.op_times(prof, steps=2)
    assert device == []
    relu = [r for r in host if r[0] == 'aten::relu']
    assert relu and relu[0][2] == 1 and relu[0][1] > 0
    assert [r[1] for r in host] == sorted((r[1] for r in host),
                                          reverse=True)
    assert not list(tmp_path.iterdir())


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    """Without a card and without a device asked for, the distributed
    entry points raise instead of falling back to the CPU; asked for the
    CPU, they take it (gloo)."""
    from pna_tpu_torch.parallel import multihost
    from pna_tpu_torch.parallel.partition import (make_distributed_aggregate,
                                                  partition_edges)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for call in (multihost.default_backend, multihost.rank_device):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert multihost.default_backend('cpu') == 'gloo'
    assert multihost.rank_device('cpu') == torch.device('cpu')
    part = partition_edges(np.array([0, 1]), np.array([1, 0]), 2, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_distributed_aggregate(part, 0)


def test_debug_nans_toggles_anomaly_mode():
    profiling.debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()
