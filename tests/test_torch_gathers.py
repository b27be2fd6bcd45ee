"""Every gather of the sparse, PyG and segment paths that autograd tracks is
an ``index_select`` (``ops/segment.py::gather_rows``), whose backward adds
with ``index_add_``, and not ``x[index]``, whose backward (``index_put_``
with accumulate, the autograd node ``IndexBackward0``) adds an index's
duplicates one after another: on the card a power-law sender of 380,000
edges made that most of a step.

On a small graph with a hub sender and a hub receiver (64 nodes, 600 edges:
node 3 sends 200 of them, node 7 receives 200), drawn from a seed, each
layer of ``chip_smoke.py``'s sparse_powerlaw phase at narrow widths, and
``segment_softmax_weights`` and ``segment_moment``:

* the loss's backward graph holds no ``IndexBackward0`` node;
* values and gradients (every parameter and the input) agree with the JAX
  layer on the same weights, at the tolerances of tests/test_torch_sparse.py
  (outputs rtol 1e-5, atol 1e-5; gradients within 1e-4 of the largest
  gradient entry; the moment's output atol 1e-4, its MOMENT_ATOL).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu import graph as jgraph
from pna_tpu.nn import pyg as jpyg
from pna_tpu.nn import sparse as jsparse
from pna_tpu.ops import segment as jseg
from pna_tpu_torch import graph as tgraph
from pna_tpu_torch.nn import pyg as tpyg
from pna_tpu_torch.nn import sparse as tsparse
from pna_tpu_torch.ops import segment as tseg
from tests.test_torch_sparse import MOMENT_ATOL, _close, _compare_layer

AGGS = ('mean', 'max', 'min', 'std')
PYG_AGGS = ('mean', 'min', 'max', 'std')
SCAL = ('identity', 'amplification', 'attenuation')
SEGMENT_AGGS = ('identity', 'normalised_mean', 'softmax', 'softmin',
                'moment3')
N_NODES, HUB_SENDER, HUB_RECEIVER, HUB_EDGES = 64, 3, 7, 200
F = 15           # divisible by the 5 towers


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Sums of the CPU's index_add_ in one fixed order, beside other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _hub_graphs():
    """(port Graph, JAX Graph, avg_d): 200 edges from the hub sender, 200
    into the hub receiver and 200 others, receiver-sorted with edge_ptr;
    node features [64, F]."""
    rng = np.random.RandomState(0)
    others = rng.randint(0, N_NODES, (3, HUB_EDGES))
    snd = np.concatenate([np.full(HUB_EDGES, HUB_SENDER), others[0],
                          others[1]])
    rcv = np.concatenate([others[2], np.full(HUB_EDGES, HUB_RECEIVER),
                          rng.randint(0, N_NODES, HUB_EDGES)])
    rec = dict(node_feats=rng.randn(N_NODES, F).astype(np.float32),
               senders=snd.astype(np.int32), receivers=rcv.astype(np.int32))
    tg = tgraph.batch_graphs([rec], with_snorm=True)
    jg = jgraph.batch_graphs([rec], with_snorm=True, with_ell=False)
    assert tg.edge_ptr is not None and tg.max_in_degree >= HUB_EDGES
    assert int(tg.out_degrees()[HUB_SENDER]) >= HUB_EDGES
    deg = np.bincount(rcv, minlength=N_NODES).astype(np.float64)
    return tg, jg, {'lin': float(deg.mean()),
                    'log': float(np.log(deg + 1).mean())}


# name -> (JAX module, port module's constructor, the flax layer takes
# ``train``); every layer of the phase at width F
def _layers(avg_d):
    return {
        'hiv_simple': (
            jsparse.PNASimpleLayerSparse(out_dim=F, aggregators=AGGS,
                                         scalers=SCAL, avg_d=avg_d,
                                         batch_norm=True, residual=True),
            lambda: tsparse.PNASimpleLayerSparse(
                F, F, AGGS, SCAL, avg_d, batch_norm=True, residual=True,
                device='cpu'), True),
        'zinc_towers': (
            jsparse.PNALayerSparse(out_dim=F, aggregators=AGGS, scalers=SCAL,
                                   avg_d=avg_d, graph_norm=True,
                                   batch_norm=True, towers=5,
                                   divide_input=False, residual=True),
            lambda: tsparse.PNALayerSparse(
                F, F, AGGS, SCAL, avg_d, graph_norm=True, batch_norm=True,
                towers=5, divide_input=False, residual=True, device='cpu'),
            True),
        'pyg_simple': (
            jpyg.PNAConvSimplePyG(out_channels=F, aggregators=PYG_AGGS,
                                  scalers=SCAL, avg_deg=avg_d),
            lambda: tpyg.PNAConvSimplePyG(F, F, PYG_AGGS, SCAL, avg_d,
                                          device='cpu'), False),
        'pyg_towers': (
            jpyg.PNAConvPyG(out_channels=F, aggregators=PYG_AGGS,
                            scalers=SCAL, avg_deg=avg_d, towers=5),
            lambda: tpyg.PNAConvPyG(F, F, PYG_AGGS, SCAL, avg_d, towers=5,
                                    device='cpu'), False),
        'gcn': (jsparse.GCNLayerSparse(out_features=F),
                lambda: tsparse.GCNLayerSparse(F, F, device='cpu'), True),
        'gat': (jsparse.GATLayerSparse(out_features=F),
                lambda: tsparse.GATLayerSparse(F, F, device='cpu'), True),
        'gin': (jsparse.GINLayerSparse(out_features=F),
                lambda: tsparse.GINLayerSparse(F, F, device='cpu'), True),
    }


def _segment_fns(g, avg_d, module):
    """The functions of the segment form, h [N, F] -> output, in the port
    (``module`` tseg/tsparse) or JAX (jseg/jsparse) spelling: the bank with
    identity, normalised_mean, softmax, softmin and moment3 over h's sender
    gather, and segment_softmax_weights and segment_moment over it."""
    is_jax = module == 'jax'
    seg_mod = jseg if is_jax else tseg
    sparse_mod = jsparse if is_jax else tsparse
    snd, rcv = g.senders, g.receivers
    gather = ((lambda h: h[jnp.asarray(snd)]) if is_jax
              else (lambda h: torch.index_select(h, 0, snd)))
    n = g.n_node_pad
    return {
        'segment_bank': lambda h: sparse_mod.aggregate_bank(
            g, gather(h), SEGMENT_AGGS, SCAL, avg_d, self_msg=h),
        'segment_softmax_weights': lambda h: seg_mod.segment_softmax_weights(
            gather(h), rcv, n, g.edge_mask),
        'segment_moment': lambda h: seg_mod.segment_moment(
            gather(h), rcv, n, 3, g.edge_mask),
    }


CASES = ['hiv_simple', 'zinc_towers', 'pyg_simple', 'pyg_towers', 'gcn',
         'gat', 'gin', 'segment_bank', 'segment_softmax_weights',
         'segment_moment']


def _backward_nodes(t):
    """The names of every node of ``t``'s backward graph."""
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(fn.name())
        stack.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("case", CASES)
def test_no_index_backward_in_the_gradient(case):
    """The loss's backward graph reaches the gathers as IndexSelectBackward0
    nodes and holds no IndexBackward0 (x[index]'s backward)."""
    tg, _, avg_d = _hub_graphs()
    h = tg.node_feats.clone().requires_grad_(True)
    layers = _layers(avg_d)
    if case in layers:
        out = layers[case][1]()(tg, h)
    else:
        out = _segment_fns(tg, avg_d, 'torch')[case](h)
    loss = torch.sin(out).sum()
    names = _backward_nodes(loss)
    assert 'IndexBackward0' not in names, sorted(names)
    assert 'IndexSelectBackward0' in names
    loss.backward()
    assert bool(torch.isfinite(h.grad).all())


@pytest.mark.parametrize("case", CASES)
def test_hub_graph_matches_jax(case):
    """Each case on the hub graph against the JAX layer or function on the
    same weights and features: outputs and every gradient."""
    tg, jg, avg_d = _hub_graphs()
    h = tg.node_feats.numpy()
    layers = _layers(avg_d)
    if case in layers:
        jmod, make, has_train = layers[case]
        _compare_layer(jmod, make, tg, jg, h, None, lambda g, x, e: (g, x),
                       has_train=has_train)
        return
    rows = np.asarray(jg.edge_mask if case == 'segment_softmax_weights'
                      else jg.node_mask, np.float32)[:, None]
    jfn = _segment_fns(jg, avg_d, 'jax')[case]

    def lf(x):
        out = jfn(x)
        return jnp.sum(jnp.sin(out) * rows), out

    # eagerly, as tests/test_torch_sparse.py runs the segment functions:
    # where every message of a node is the same (the hub sender's, repeated)
    # the odd moment is 0 in exact arithmetic, and XLA's fused cube under
    # jit rounds it to noise that the root turns into +-EPS^(1/3)
    (_, out_j), gh = jax.value_and_grad(lf, has_aux=True)(h)
    ht = torch.from_numpy(h.copy()).requires_grad_(True)
    out = _segment_fns(tg, avg_d, 'torch')[case](ht)
    (torch.sin(out) * torch.from_numpy(rows)).sum().backward()
    _close(out.detach(), out_j, rtol=1e-5,
           atol=MOMENT_ATOL if case == 'segment_moment' else 1e-5)
    gh = np.asarray(gh)
    scale = float(np.abs(gh).max())
    err = float(np.abs(ht.grad.numpy() - gh).max())
    assert err <= 1e-4 * scale, (err, scale)
