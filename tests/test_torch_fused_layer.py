"""PNALayerFused of the port against the JAX layer, with the same weights
carried across by weights.from_jax: kernel='csr' against the JAX
kernel='pallas' and kernel='csr_fused' against the JAX kernel='pallas_fused'
(both in interpret mode): output, every parameter gradient, the input
gradients and the new batch-norm statistics.  Tolerances: outputs rtol 1e-4,
atol 1e-4; gradients rtol 2e-4, atol 2e-5 (as tests/test_pallas_bank.py
holds two JAX backends to each other).

With compute_dtype=bfloat16, both backends against the JAX bfloat16 path:
the loss within rtol 1e-2 and every gradient tensor within 5e-2 of its norm.
Both sides round the same operands to bfloat16 and add the products in
float32, but in other orders; a float32 difference of one unit in the last
place moves a value across a bfloat16 rounding boundary now and then, which
changes that value by 2^-8 of itself, and on 'csr' the bfloat16 messages
tie often, so a changed rounding can move a max/min gradient to another
edge.  The port agrees with JAX far inside the bounds (about 1e-6 on 'csr'
and 1e-3 on 'csr_fused' at these sizes), while the float32 gradients lie
outside them (about 0.1 from the bfloat16 ones), which the test checks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu.graph import batch_graphs as j_batch_graphs
from pna_tpu.nn.fused import PNALayerFused as JPNALayerFused
from pna_tpu_torch.graph import batch_graphs
from pna_tpu_torch.nn.fused import PNALayerFused
from pna_tpu_torch.weights import from_jax

AGGS = ('mean', 'max', 'min', 'std')
SCALERS = ('identity', 'amplification', 'attenuation')
AVG_D = {'lin': 3.1, 'log': 1.2}
D, FE, T = 12, 5, 3
JAX_KERNEL = {'csr': 'pallas', 'csr_fused': 'pallas_fused'}
JAX_DTYPE = {torch.float32: None, torch.bfloat16: jnp.bfloat16}


def _graphs(rng):
    graphs = []
    for _ in range(6):
        n = rng.randint(5, 12)
        adj = (rng.rand(n, n) < 0.4) & ~np.eye(n, dtype=bool)
        s, r = np.nonzero(adj)
        graphs.append(dict(node_feats=rng.randn(n, 2).astype(np.float32),
                           senders=s.astype(np.int32),
                           receivers=r.astype(np.int32)))
    return graphs


def _run_both(kernel, divide_input, edge_features, cdt=torch.float32,
              **layer_kw):
    """One training-mode forward and backward of loss = sum(out^2) through
    the JAX layer and the port's layer on the same weights and inputs;
    ``layer_kw`` reach both layers."""
    rng = np.random.RandomState(1)
    graphs = _graphs(rng)
    tg = batch_graphs(graphs, with_snorm=True)
    jg = j_batch_graphs(graphs, with_snorm=True, with_ell=False,
                        sort_edges=True)
    h = rng.randn(tg.n_node_pad, D).astype(np.float32)
    e = rng.randn(tg.n_edge_pad, FE).astype(np.float32)
    h[0] = h[1]                          # equal messages: max/min ties

    jl = JPNALayerFused(out_dim=D, aggregators=AGGS, scalers=SCALERS,
                        avg_d=AVG_D, towers=T, divide_input=divide_input,
                        graph_norm=True, batch_norm=True, residual=True,
                        edge_features=edge_features,
                        kernel=JAX_KERNEL[kernel],
                        compute_dtype=JAX_DTYPE[cdt], pallas_interpret=True,
                        **layer_kw)
    je = jnp.asarray(e) if edge_features else None
    var = jax.tree_util.tree_map(np.asarray, jl.init(
        {'params': jax.random.PRNGKey(0)}, jg, jnp.asarray(h), je,
        train=False))

    def jloss(p, h, e):
        out, mut = jl.apply({'params': p,
                             'batch_stats': var['batch_stats']}, jg, h, e,
                            train=True, mutable=['batch_stats'])
        return jnp.sum(out * out), (out, mut['batch_stats'])

    (l_j, (out_j, stats_j)), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2) if edge_features else (0, 1),
        has_aux=True)(var['params'], jnp.asarray(h), je)

    tl = PNALayerFused(D, D, AGGS, SCALERS, AVG_D, towers=T,
                       divide_input=divide_input, graph_norm=True,
                       batch_norm=True, residual=True,
                       edge_features=edge_features, edge_dim=FE,
                       kernel=kernel, compute_dtype=cdt, device='cpu',
                       **layer_kw)
    tl.load_state_dict(from_jax(var['params'], var['batch_stats']))
    tl.train()
    ht = torch.from_numpy(h).requires_grad_(True)
    et = torch.from_numpy(e).requires_grad_(True) if edge_features else None
    out_t = tl(tg, ht, et)
    l_t = torch.sum(out_t * out_t)
    l_t.backward()

    want = from_jax(jax.tree_util.tree_map(np.asarray, grads_j[0]))
    got = {k: p.grad for k, p in tl.named_parameters()}
    assert set(want) == set(got)
    pairs = [(k, got[k].numpy(), w.numpy()) for k, w in want.items()]
    pairs.append(('h', ht.grad.numpy(), np.asarray(grads_j[1])))
    if edge_features:
        pairs.append(('e', et.grad.numpy(), np.asarray(grads_j[2])))
    stats = from_jax({}, jax.tree_util.tree_map(np.asarray, stats_j))
    stat_pairs = [(k, tl.state_dict()[k].numpy(), w.numpy())
                  for k, w in stats.items()]
    return ((float(l_t.detach()), out_t.detach().numpy(), pairs, stat_pairs),
            (float(l_j), np.asarray(out_j)))


def _check_f32(kernel, divide_input, edge_features, **layer_kw):
    (l_t, out_t, pairs, stat_pairs), (l_j, out_j) = _run_both(
        kernel, divide_input, edge_features, **layer_kw)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-4)
    g_tol = dict(rtol=2e-4, atol=2e-5)
    for k, g, w in pairs:
        np.testing.assert_allclose(g, w, **g_tol, err_msg=k)
    for k, g, w in stat_pairs:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("divide_input", [True, False])
@pytest.mark.parametrize("edge_features", [True, False])
def test_fused_layer_matches_jax(divide_input, edge_features):
    _check_f32('csr', divide_input, edge_features)


@pytest.mark.parametrize("divide_input", [True, False])
@pytest.mark.parametrize("edge_features", [True, False])
def test_csr_fused_layer_matches_jax(divide_input, edge_features):
    """kernel='csr_fused' (K3/K4) against the JAX kernel='pallas_fused'."""
    _check_f32('csr_fused', divide_input, edge_features)


@pytest.mark.parametrize("divide_input", [True, False])
def test_two_pretrans_and_posttrans_layers_match_jax(divide_input):
    """pretrans_layers=2 and posttrans_layers=2 on 'csr' against the JAX
    'pallas' layer: kernel_1/bias_1 of both stacks, relu on the messages
    between the pretrans layers and after the scaler contraction."""
    _check_f32('csr', divide_input, True, pretrans_layers=2,
               posttrans_layers=2)


def test_csr_fused_takes_one_pretrans_layer():
    with pytest.raises(ValueError, match="pretrans_layers=1"):
        PNALayerFused(D, D, AGGS, SCALERS, AVG_D, kernel='csr_fused',
                      pretrans_layers=2, device='cpu')
    layer = PNALayerFused(D, D, AGGS, SCALERS, AVG_D, kernel='csr_fused',
                          posttrans_layers=3, device='cpu')
    assert {n for n, _ in layer.posttrans.named_parameters()} == {
        'kernel_0', 'bias_0', 'kernel_1', 'bias_1', 'kernel_2', 'bias_2'}


def rel_norm_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("kernel", ['csr', 'csr_fused'])
def test_bf16_layer_matches_jax_bf16(kernel):
    """compute_dtype=bfloat16 against the JAX bfloat16 path (tolerances in
    the module docstring)."""
    (l_t, out_t, pairs, _), (l_j, out_j) = _run_both(
        kernel, True, True, torch.bfloat16)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-2)
    for k, g, w in pairs:
        assert rel_norm_err(g, w) <= 5e-2, (k, rel_norm_err(g, w))
    # the bound tells bfloat16 from float32: the float32 layer's gradients
    # lie outside it
    (_, _, pairs32, _), _ = _run_both(kernel, True, True)
    assert max(rel_norm_err(g, g32) for (_, g, _), (_, g32, _)
               in zip(pairs, pairs32)) > 5e-2


# the ids are the cases' names from when the tower and distributed options
# were still to port (they raised NotImplementedError then)
@pytest.mark.parametrize("kw,err,match", [
    (dict(kernel='auto', tp_group='model'), TypeError, "process group"),
    (dict(kernel='bucketed', tp_group='model'), ValueError,
     "unknown kernel"),
    (dict(kernel='ell', tp_group='model'), ValueError, "unknown kernel"),
    (dict(kernel='generic', tp_group='model'), TypeError, "process group"),
    (dict(kernel='pallas_fused'), ValueError, "'csr_fused'"),
    (dict(kernel='pallas'), ValueError, "'csr'"),
    (dict(compute_dtype=torch.float16), NotImplementedError, "nor any CLI"),
    (dict(tp_group='model'), TypeError, "process group"),
], ids=[f"kw{i}-{e}" for i, e in enumerate(
    ['NotImplementedError'] * 4 + ['ValueError'] * 2
    + ['NotImplementedError'] * 2)])
def test_unported_options_raise(kw, err, match):
    """Options the port does not take raise, on every backend: the JAX
    names of the kernel backends raise naming the port's, the JAX bucketed
    and ELL backends, which the port does not have, raise as unknown,
    float16 says that nothing runs it, and tower TP takes a process group,
    not a mesh axis name."""
    with pytest.raises(err, match=match):
        PNALayerFused(D, D, AGGS, SCALERS, AVG_D, device='cpu', **kw)


def test_distributed_arguments_raise():
    """Malformed distributed arguments raise: a sender table of another
    width than h, an overlap tuple without the split tables."""
    rng = np.random.RandomState(2)
    tg = batch_graphs(_graphs(rng), with_snorm=True)
    tl = PNALayerFused(D, D, AGGS, SCALERS, AVG_D, device='cpu')
    h = torch.zeros(tg.n_node_pad, D)
    with pytest.raises(ValueError, match="width"):
        tl(tg, h, sender_table=h[:, 1:])
    with pytest.raises(ValueError, match="overlap takes 7"):
        tl(tg, h, overlap=(h,))


# the overlap path on one part of a partitioned graph
OV_NODES, OV_EDGES, OV_PARTS = 60, 420, 4


def _overlap_inputs(p, edge_features):
    """Part ``p`` of a 4-way ``partition_edges`` of a power-law graph (the
    port's tables, element for element the JAX package's:
    tests/test_torch_partition.py), split by ``split_edges``: its graph,
    its rows of the split tables, and random local node rows, halo rows and
    edge rows (``e``, the part's edge features; its local and boundary
    rows are taken by ``idx_local``/``idx_bound``)."""
    from pna_tpu_torch.parallel.distributed_net import _local_graph
    from pna_tpu_torch.parallel.partition import (partition_edges,
                                                  powerlaw_graph,
                                                  split_edges)
    send, recv = powerlaw_graph(OV_NODES, OV_EDGES, seed=5)
    part = partition_edges(send, recv, OV_NODES, OV_PARTS)
    sp = split_edges(part)
    rows = {f: np.ascontiguousarray(getattr(sp, f)[p]) for f in (
        'senders_local', 'receivers_local', 'mask_local', 'senders_bound',
        'receivers_bound', 'mask_bound', 'idx_local', 'idx_bound')}
    assert rows['mask_bound'].any() and rows['mask_local'].any()
    nl = part.nodes_per_part
    tables = [np.ascontiguousarray(a[p]) for a in (
        part.senders_local, part.receivers_local, part.edge_mask,
        part.node_mask)]
    rng = np.random.RandomState(10 + p)
    h = rng.randn(nl, D).astype(np.float32)
    halo = rng.randn(OV_PARTS * part.halo_size, D).astype(np.float32)
    e = (rng.randn(part.edges_per_part, FE).astype(np.float32)
         if edge_features else None)
    tg = _local_graph(nl, *(torch.from_numpy(a) for a in tables))
    return tg, tables, rows, h, halo, e


@pytest.mark.parametrize("edge_features", [False, True])
@pytest.mark.parametrize("part", range(OV_PARTS))
def test_overlap_layer_matches_jax_overlap(part, edge_features):
    """The layer alone on its ``overlap`` path, the local and the boundary
    edges of one part aggregated into one moment sketch, against the JAX
    layer's overlap path on the same weights and split tables: output, loss
    = sum(out^2), every parameter gradient, the gradients of h, of the halo
    rows and of the edge rows, and the new batch-norm statistics, at the
    float32 tolerances of the module docstring, but for the parameter
    gradients: without graph norm (the distributed net's layers have none)
    the posttrans bias meets the batch norm directly and its gradient is 0
    but for float noise, so they are held as tests/test_torch_distributed.py
    holds the nets' on this path, each within 2e-3 of its scale (its
    largest entry, but at least 1e-3 of the layer's largest entry)."""
    from pna_tpu.parallel.distributed_net import _local_graph as j_local
    tg, tables, rows, h, halo, e = _overlap_inputs(part, edge_features)
    jg = j_local(tg.n_node_pad, *(jnp.asarray(a) for a in tables))
    idx = ('senders_local', 'receivers_local', 'mask_local',
           'senders_bound', 'receivers_bound', 'mask_bound')
    jl = JPNALayerFused(out_dim=D, aggregators=AGGS, scalers=SCALERS,
                        avg_d=AVG_D, towers=T, batch_norm=True,
                        residual=True, edge_features=edge_features)
    var = jax.tree_util.tree_map(np.asarray, jl.init(
        {'params': jax.random.PRNGKey(0)}, jg, jnp.asarray(h),
        None if e is None else jnp.asarray(e), train=False))

    def jloss(p, h, halo, e):
        ov = (halo,) + tuple(jnp.asarray(rows[f]) for f in idx)
        if edge_features:
            ov = ov + (e[rows['idx_local']], e[rows['idx_bound']])
        out, mut = jl.apply({'params': p, 'batch_stats': var['batch_stats']},
                            jg, h, e, train=True, overlap=ov,
                            mutable=['batch_stats'])
        return jnp.sum(out * out), (out, mut['batch_stats'])

    (l_j, (out_j, stats_j)), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3) if edge_features else (0, 1, 2),
        has_aux=True)(var['params'], jnp.asarray(h), jnp.asarray(halo),
                      None if e is None else jnp.asarray(e))

    tl = PNALayerFused(D, D, AGGS, SCALERS, AVG_D, towers=T,
                       batch_norm=True, residual=True,
                       edge_features=edge_features, edge_dim=FE,
                       device='cpu')
    tl.load_state_dict(from_jax(var['params'], var['batch_stats']))
    tl.train()
    ht, halo_t = (torch.from_numpy(a).requires_grad_(True)
                  for a in (h, halo))
    ov = (halo_t,) + tuple(torch.from_numpy(rows[f]).long()
                           if 'mask' not in f else torch.from_numpy(rows[f])
                           for f in idx)
    et = None
    if edge_features:
        et = torch.from_numpy(e).requires_grad_(True)
        ov = ov + tuple(et[torch.from_numpy(rows[f]).long()]
                        for f in ('idx_local', 'idx_bound'))
    out_t = tl(tg, ht, et, overlap=ov)
    l_t = torch.sum(out_t * out_t)
    l_t.backward()

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    want = {k: w.numpy() for k, w in from_jax(jax.tree_util.tree_map(
        np.asarray, grads_j[0])).items()}
    got = {k: p.grad.numpy() for k, p in tl.named_parameters()}
    assert set(want) == set(got)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()),
                                                     1e-3 * top)
        assert err <= 2e-3, (k, err)
    pairs = [('h', ht.grad.numpy(), np.asarray(grads_j[1])),
             ('halo', halo_t.grad.numpy(), np.asarray(grads_j[2]))]
    if edge_features:
        pairs.append(('e', et.grad.numpy(), np.asarray(grads_j[3])))
    for k, g, w in pairs:
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=k)
    stats = from_jax({}, jax.tree_util.tree_map(np.asarray, stats_j))
    for k, w in stats.items():
        np.testing.assert_allclose(tl.state_dict()[k].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
