"""The distributed PNA net of the port against pna_tpu's.

* The oracle: ``DistributedPNANet`` without groups on ``full_graph`` against
  the JAX net on its ``full_graph``, on the same weights (``from_jax``), on
  the generic, csr and csr_fused backends (the kernels' plain versions on
  the CPU), with the graph readout and with the node-level head and edge
  features; and the JAX net on its bucketed backend over a bucketized
  one-part partition against the port's csr on the same graph (the port has
  no bucketed layout).  Loss rtol 1e-5, every
  gradient within 2e-3 of its scale (its largest entry, but at least 1e-3
  of the model's largest gradient entry, as the other net tests hold them).
* The step: four spawned gloo ranks run one SGD (1e-2) step of the
  partitioned net (``make_distributed_train_step``) and are held against the
  JAX single-device oracle step with the JAX tests' own tolerances
  (``tests/test_distributed_net.py``): loss rtol 1e-4; parameters rtol
  2e-3, atol 2e-4; batch-norm statistics rtol 1e-4, atol 1e-5.  Cases:
  ``d_graph`` 4 on generic, with edge features, with ``overlap`` (with and
  without edge features), on csr and csr_fused (sorted partition); and a
  2 x 2 ``hybrid_mesh`` (data x
  graph, batch norm off, as the JAX data-parallel test runs it).  As in
  the JAX tests, duplicate (sender, receiver) pairs are dropped: the
  partition reorders edges, and max/min tie-breaking would then differ.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pna_tpu.parallel.distributed_net import DistributedPNANet as JNet
from pna_tpu.parallel.distributed_net import full_graph as jfull_graph
from pna_tpu.parallel.distributed_net import _local_graph as _jlocal_graph
from pna_tpu.parallel.distributed_net import init_net as jinit_net
from pna_tpu.parallel import partition as jpartition
from pna_tpu_torch.parallel import partition as tpartition
from pna_tpu_torch.parallel.distributed_net import (DistributedPNANet,
                                                    full_graph)
from pna_tpu_torch.weights import from_jax

from tests import _torch_dist_ranks as ranks

AGGS = ('mean', 'max', 'min', 'std')
SCAL = ('identity', 'amplification', 'attenuation')
AVG_D = {'lin': 2.0, 'log': 1.1}
NUM_NODES, NUM_EDGES, F, FE = 48, 200, 6, 5


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

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _edges(every_node_receives=False):
    """The power-law graph's distinct edges; with ``every_node_receives``,
    an edge from node i + 1 into every node i without in-edges."""
    send, recv = jpartition.powerlaw_graph(NUM_NODES, NUM_EDGES, seed=2)
    if every_node_receives:
        lone = np.nonzero(np.bincount(recv, minlength=NUM_NODES) == 0)[0]
        send = np.concatenate([send, (lone + 1) % NUM_NODES])
        recv = np.concatenate([recv, lone])
    pairs = np.unique(send * NUM_NODES + recv)
    return pairs // NUM_NODES, pairs % NUM_NODES


def _jpart(send, recv, d_graph, layout=None):
    """The JAX partition in ``layout``: None, 'sorted' or 'bucketed'."""
    part = jpartition.partition_edges(send, recv, NUM_NODES, d_graph)
    if layout == 'bucketed':
        part = jpartition.bucketize_partition(part)
    elif layout == 'sorted':
        part = jpartition.sort_partition_edges(part)
    return part


def _jnet(batch_norm=True, n_layers=2, edge_features=False, overlap=False,
          node_level=False):
    return JNet(hidden_dim=8, out_dim=8, n_layers=n_layers, towers=2,
                aggregators=AGGS, scalers=SCAL, avg_d=AVG_D,
                batch_norm=batch_norm, residual=True,
                bn_axes=('data', 'graph'), edge_features=edge_features,
                overlap=overlap, node_level=node_level)


def _net_kw(batch_norm=True, n_layers=2, edge_features=False, overlap=False,
            node_level=False, kernel='auto'):
    return dict(hidden_dim=8, out_dim=8, n_layers=n_layers, towers=2,
                aggregators=AGGS, scalers=SCAL, avg_d=AVG_D,
                batch_norm=batch_norm, residual=True, kernel=kernel,
                edge_features=edge_features, overlap=overlap,
                node_level=node_level)


def _edge_feats(part, ef, n_pad_edges):
    e_full = np.zeros((n_pad_edges, ef.shape[1]), np.float32)
    e_full[:len(ef)] = ef
    return e_full


def _grad_scale_errors(got, want):
    """{name: max |got - want| / scale} over the gradients."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(got[k] - w).max())
            / max(float(np.abs(w).max()), 1e-3 * top)
            for k, w in want.items()}


# -- the oracle ------------------------------------------------------------


@pytest.mark.parametrize("kernel,node_level", [
    ('generic', False), ('csr', False), ('csr_fused', False),
    ('generic', True), ('csr', True), ('csr_fused', True),
    ('bucketed', True)])
def test_oracle_matches_jax_oracle(kernel, node_level):
    """No groups: the port's single-device net on the same graph and
    weights as the JAX oracle: loss and every gradient.  The node-level
    cases carry edge features.  The bucketed case runs the JAX net on one
    part of a bucketized partition (the whole graph in the bucketed layout)
    on its bucketed backend, and the port's on its one-part graph on
    ``csr``, whose sketch sums the variance of a one-edge node as the
    bucketed one does, E[x^2] - E[x]^2 (the rounding decides the clamp's
    gradient there): features, targets and mask reach the port's nodes
    through the partitions' node orders.  The JAX bucketed path defines std
    as 0 on a node without in-edges, where its other paths and every port
    backend give sqrt(EPS), so that case gives every node an in-edge."""
    send, recv = _edges(every_node_receives=kernel == 'bucketed')
    d_graph = 1 if kernel == 'bucketed' else 4
    layout = 'bucketed' if kernel == 'bucketed' else None
    part_j = _jpart(send, recv, d_graph, layout)
    part_t = tpartition.partition_edges(send, recv, NUM_NODES, d_graph)
    ef = (np.random.RandomState(3).randn(len(send), FE).astype(np.float32)
          if node_level else None)
    efeats = part_j.scatter_edge_features(ef) if node_level else None
    jnet = _jnet(node_level=node_level, edge_features=node_level)
    params, stats = jinit_net(jnet, part_j, F, seed=0, efeats=efeats)
    feats = part_j.scatter_features(np.random.RandomState(0).randn(
        NUM_NODES, F).astype(np.float32)).reshape(-1, F)
    targets = np.linspace(-1.0, 1.0, feats.shape[0]).astype(np.float32)
    mask = part_j.node_mask.reshape(-1)
    if kernel == 'bucketed':
        jnet = jnet.clone(kernel='bucketed')
        g_j = _jlocal_graph(
            part_j.nodes_per_part, jnp.asarray(part_j.senders_local[0]),
            jnp.asarray(part_j.receivers_local[0]),
            jnp.asarray(part_j.edge_mask[0]),
            jnp.asarray(part_j.node_mask[0]),
            bucket_spec=part_j.bucket_spec,
            in_deg=jnp.asarray(part_j.in_deg[0]))
        e_j = jnp.asarray(efeats[0])
    else:
        g_j = jfull_graph(part_j, send, recv)
        e_j = (jnp.asarray(_edge_feats(part_j, ef, g_j.senders.shape[0]))
               if node_level else None)

    def loss_fn(p):
        pred, _ = jnet.apply({'params': p, 'batch_stats': stats}, g_j,
                             jnp.asarray(feats), None, None, train=True,
                             mutable=['batch_stats'], e=e_j)
        if node_level:
            return jnp.sum(((pred - targets) ** 2) * mask) / mask.sum()
        return (pred - 0.7) ** 2

    grad_fn = jax.value_and_grad(loss_fn)
    if kernel == 'bucketed':       # one program, not an op-by-op trace
        grad_fn = jax.jit(grad_fn)
    l_j, g_jax = grad_fn(params)

    port_kernel = 'csr' if kernel == 'bucketed' else kernel
    net = DistributedPNANet(F, device='cpu', edge_dim=FE if node_level else 0,
                            **_net_kw(node_level=node_level,
                                      edge_features=node_level,
                                      kernel=port_kernel))
    net.load_state_dict(from_jax(_np(params), _np(stats)))
    net.train()
    g_t = full_graph(part_t, send, recv, efeats=ef,
                     sort_edges=port_kernel != 'generic')
    e_t = g_t.edge_feats
    feats_t, targets_t, mask_t = feats, targets, mask
    if kernel == 'bucketed':
        # the port's row of each node from the JAX bucketized row
        pos_t, pos_j = part_t._positions(), part_j._positions()
        n_pad = part_t.num_parts * part_t.nodes_per_part
        feats_t = np.zeros((n_pad, F), np.float32)
        targets_t = np.zeros(n_pad, np.float32)
        feats_t[pos_t], targets_t[pos_t] = feats[pos_j], targets[pos_j]
        mask_t = part_t.node_mask.reshape(-1)
    pred = net(g_t, torch.from_numpy(feats_t), e=e_t)
    y, m = torch.from_numpy(targets_t), torch.from_numpy(mask_t)
    if node_level:
        loss = (((pred - y) ** 2) * m).sum() / m.sum()
    else:
        loss = (pred - 0.7) ** 2
    loss.backward()
    note = (" [graph with an in-edge into every node: the JAX bucketed "
            "path sets std to 0 on a node without in-edges, its other "
            "paths and the port sqrt(EPS)]" if kernel == 'bucketed' else "")
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-5,
                               err_msg=note)
    want = {k: v.numpy() for k, v in from_jax(_np(g_jax)).items()}
    got = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(got) == set(want)
    errs = _grad_scale_errors(got, want)
    assert max(errs.values()) <= 2e-3, (sorted(errs.items(),
                                               key=lambda kv: -kv[1])[:4],
                                        note)


# -- the step over four spawned ranks ----------------------------------------


def _oracle_step(jnet, params, stats, g_full, feats_all, targets, e_full):
    """The JAX tests' single-device SGD step: the mean over the data
    elements of the squared error, one SGD step of 1e-2."""
    tx = optax.sgd(1e-2)

    def loss_fn(p):
        losses, new_stats = [], stats
        for d in range(feats_all.shape[0]):
            pred, mutated = jnet.apply(
                {'params': p, 'batch_stats': stats}, g_full, feats_all[d],
                None, None, train=True, mutable=['batch_stats'], e=e_full)
            new_stats = mutated['batch_stats']
            losses.append((pred - targets[d]) ** 2)
        return jnp.mean(jnp.asarray(losses)), new_stats

    (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return float(loss), optax.apply_updates(params, updates), new_stats


CASES = {
    'generic': dict(),
    'edge_features': dict(edge_features=True),
    'overlap': dict(overlap=True),
    'overlap_edge_features': dict(overlap=True, edge_features=True),
    'csr': dict(kernel='csr', layout='sorted'),
    'csr_fused': dict(kernel='csr_fused', layout='sorted'),
    'data_2x2': dict(d_data=2, batch_norm=False),
}


def _case(name, send, recv):
    c = dict(CASES[name])
    d_data = c.pop('d_data', 1)
    d_graph = 4 // d_data
    layout = c.pop('layout', None)
    kernel = c.pop('kernel', 'auto')
    batch_norm = c.pop('batch_norm', True)
    ef_on = c.get('edge_features', False)
    part = _jpart(send, recv, d_graph, layout)
    rng = np.random.RandomState(4)
    ef = rng.randn(len(send), FE).astype(np.float32) if ef_on else None
    jnet = _jnet(batch_norm=batch_norm, **c)
    params, stats = jinit_net(
        jnet, part, F, seed=0,
        efeats=part.scatter_edge_features(ef) if ef_on else None)
    g_full = jfull_graph(part, send, recv)
    feats = np.stack([part.scatter_features(np.random.RandomState(d).randn(
        NUM_NODES, F).astype(np.float32)).reshape(-1, F)
        for d in range(d_data)])
    targets = np.asarray([0.7, -1.1][:d_data], np.float32)
    e_full = (jnp.asarray(_edge_feats(part, ef, g_full.senders.shape[0]))
              if ef_on else None)
    want = _oracle_step(jnet, params, stats, g_full, jnp.asarray(feats),
                        jnp.asarray(targets), e_full)
    case = dict(send=send, recv=recv, num_nodes=NUM_NODES, d_data=d_data,
                d_graph=d_graph, layout=layout, feat_dim=F,
                edge_dim=FE if ef_on else 0, efeats=ef, feats=feats,
                targets=targets, lr=1e-2,
                net=_net_kw(batch_norm=batch_norm, kernel=kernel, **c),
                state=from_jax(_np(params), _np(stats)))
    return case, want


def _aggregate_case():
    """tests/test_partition.py's case (64 nodes, 400 power-law edges, F 5)
    and its single-device JAX bank."""
    from pna_tpu.graph import build_graph
    from pna_tpu.nn.sparse import aggregate_bank
    n, e, f = 64, 400, 5
    send, recv = jpartition.powerlaw_graph(n, e, seed=1)
    feats = np.random.RandomState(0).randn(n, f).astype(np.float32)
    avg_d = {'lin': 3.0, 'log': 1.2}
    g = build_graph(feats, send.astype(np.int32), recv.astype(np.int32),
                    n_node_pad=n + 1, n_edge_pad=-(-e // 128) * 128)
    msg = jnp.asarray(np.asarray(g.node_feats))[g.senders]
    ref = np.asarray(aggregate_bank(g, msg, list(AGGS), list(SCAL), avg_d))
    case = dict(send=send, recv=recv, num_nodes=n, feats=feats,
                aggregators=AGGS, scalers=SCAL, avg_d=avg_d)
    return case, ref[:n]


def test_distributed_step_matches_jax_oracle(tmp_path):
    """The seven step cases; the halo exchange under
    ``make_distributed_aggregate`` against the JAX single-device bank
    (``tests/test_partition.py``'s tolerance, 2e-4); and
    ``dryrun_multichip(4)`` on its 2 x 2 mesh (every configuration's loss
    finite and the same on every rank, the two hub-skewed backends equal),
    in one world."""
    send, recv = _edges()
    names = list(CASES)
    cases, wants = zip(*[_case(n, send, recv) for n in names])
    agg_case, agg_ref = _aggregate_case()
    out = ranks.run_world('dist_step_cases', 4, tmp_path, list(cases),
                          agg_case)
    results = [r for r, _, _ in out]
    dry = [d for _, _, d in out]
    assert set(dry[0]) == {'generic', 'csr', 'csr_fused'}
    for d in dry[1:]:
        for k, v in d.items():
            np.testing.assert_allclose(v, dry[0][k], rtol=1e-6)
    np.testing.assert_allclose(dry[0]['csr'], dry[0]['csr_fused'], rtol=1e-5)
    part = tpartition.partition_edges(agg_case['send'], agg_case['recv'],
                                      agg_case['num_nodes'], 4)
    got = part.gather_outputs(np.stack([a.numpy() for _, a, _ in out]))
    np.testing.assert_allclose(got, agg_ref, rtol=2e-4, atol=2e-4)
    for i, name in enumerate(names):
        o_loss, o_params, o_stats = wants[i]
        o_params = {k: v.numpy() for k, v in from_jax(_np(o_params)).items()}
        o_stats = {k: v.numpy() for k, v in
                   from_jax({}, _np(o_stats)).items()}
        for r, res in enumerate(results):
            got = res[i]
            np.testing.assert_allclose(got['loss'], o_loss, rtol=1e-4,
                                       err_msg=f"{name} rank {r}")
            for k, want in o_params.items():
                np.testing.assert_allclose(
                    got['state'][k].numpy(), want, rtol=2e-3, atol=2e-4,
                    err_msg=f"{name} rank {r} {k}")
            for k, want in o_stats.items():
                np.testing.assert_allclose(
                    got['state'][k].numpy(), want, rtol=1e-4, atol=1e-5,
                    err_msg=f"{name} rank {r} {k}")


def test_dryrun_multichip_one_rank():
    import pna_tpu_torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pna_tpu_torch.dryrun_multichip(1)
    losses = pna_tpu_torch.dryrun_multichip(1, device='cpu')
    assert all(np.isfinite(v) for v in losses.values())
    assert not torch.distributed.is_initialized()
