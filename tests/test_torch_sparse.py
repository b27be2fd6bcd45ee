"""The port's segment bank and sparse PNA layers against pna_tpu on the CPU:
segment_softmax_weights, segment_moment and the unclamped variance; every
entry of SEGMENT_AGGREGATORS; SCALERS and avg_d_from_degree_hist; the
Graph helpers; aggregate_bank; PNATowerSparse, PNALayerSparse,
PNASimpleLayerSparse and PNANetMolecules(fused_towers=False); the PyG
layers; the CSR bank's unclamped variance.  Inputs are numpy arrays drawn
from a seed, weights are the JAX module's, carried by weights.from_jax.
Every batch holds an isolated real node (in-degree and out-degree 0), as
the salts of OGB molecules do, and padded edges and nodes.

Tolerances: the segment functions and aggregators rtol 1e-5 (atol 1e-6;
the same float32 sums, in the same order or another; the moments atol 1e-4,
see MOMENT_ATOL); the scalers and
avg_d exactly equal (the same float32 and float64 arithmetic); layer
outputs rtol 1e-5, atol 1e-5; gradients (every parameter and the input
features) within 1e-4 of the largest gradient entry of the module (float32
sums in other orders; a bias before a batch norm has a gradient that is 0
in exact arithmetic and float noise on both sides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu import graph as jgraph
from pna_tpu.nn import pyg as jpyg
from pna_tpu.nn import sparse as jsparse
from pna_tpu.nn.nets import PNANetMolecules as JMolecules
from pna_tpu.ops import aggregators as jagg
from pna_tpu.ops import scalers as jscal
from pna_tpu.ops import segment as jseg
from pna_tpu_torch import graph as tgraph
from pna_tpu_torch.nn import pyg as tpyg
from pna_tpu_torch.nn import sparse as tsparse
from pna_tpu_torch.nn.nets import PNANetMolecules
from pna_tpu_torch.ops import aggregators as tagg
from pna_tpu_torch.ops import csr_bank
from pna_tpu_torch.ops import scalers as tscal
from pna_tpu_torch.ops import segment as tseg
from pna_tpu_torch.weights import from_jax

AGGS = ('mean', 'max', 'min', 'std')
SCAL = ('identity', 'amplification', 'attenuation')
ALL_AGGS = tuple(tagg.SEGMENT_AGGREGATORS)
AVG_D = {'log': 1.3, 'lin': 2.1}
F_IN, FE = 10, 4
# a node of two messages has odd central moments that are 0 in exact
# arithmetic and float noise in float32; the root (|m_n| + EPS)^(1/n) has
# slope (1/n) EPS^(1/n - 1) there, up to 2,000 for n = 5, so the moment
# aggregators' absolute tolerance is 1e-4
MOMENT_ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _records(n_graphs=6, seed=0, fe=FE):
    """Small random graphs with float node and edge features; graph 0 has
    an isolated node (its last), and some edges repeat a message so that
    max and min tie."""
    rng = np.random.RandomState(seed)
    out = []
    for g in range(n_graphs):
        n = rng.randint(5, 10)
        snd, rcv = [], []
        for v in range(1, n - (g == 0)):
            u = rng.randint(0, v)
            snd += [u, v]
            rcv += [v, u]
        snd += [0, 0]
        rcv += [1, 1]                    # a double edge: tied messages
        rec = dict(node_feats=rng.randn(n, F_IN).astype(np.float32),
                   senders=np.asarray(snd, np.int32),
                   receivers=np.asarray(rcv, np.int32),
                   label=0.0)
        if fe:
            rec['edge_feats'] = rng.randn(len(snd), fe).astype(np.float32)
        out.append(rec)
    return out


def _graphs(records, **kw):
    """(port Graph, JAX Graph on the segment path: no ELL layout), both
    receiver-sorted and with graph-norm factors."""
    tg = tgraph.batch_graphs(records, with_snorm=True, **kw)
    jg = jgraph.batch_graphs(records, with_snorm=True, with_ell=False, **kw)
    assert int(tg.in_degrees()[tg.node_mask].min()) == 0    # isolated node
    return tg, jg


def _close(got, want, rtol=1e-5, atol=1e-6, msg=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---- segment functions and aggregators --------------------------------

def _segment_inputs(seed=0, e=60, n=12, f=5):
    rng = np.random.RandomState(seed)
    data = rng.randn(e, f).astype(np.float32)
    ids = np.sort(rng.randint(0, n - 3, e))      # the last 3 segments empty
    mask = rng.rand(e) > 0.2
    data[1] = data[0]                            # ties
    return data, ids, mask, n


@pytest.mark.parametrize("stable", [True, False])
def test_segment_softmax_weights_match_jax(stable):
    """The port's form (max subtracted) against both JAX forms."""
    data, ids, mask, n = _segment_inputs()
    got = tseg.segment_softmax_weights(torch.from_numpy(data),
                                       torch.from_numpy(ids), n,
                                       torch.from_numpy(mask))
    want = jseg.segment_softmax_weights(data, ids, n, mask, stable=stable)
    _close(got, want)
    assert bool(torch.isfinite(got).all()) and bool((got[~mask] == 0).all())


@pytest.mark.parametrize("order", [3, 4, 5])
def test_segment_moment_matches_jax(order):
    data, ids, mask, n = _segment_inputs(seed=order)
    got = tseg.segment_moment(torch.from_numpy(data), torch.from_numpy(ids),
                              n, order, torch.from_numpy(mask))
    _close(got, jseg.segment_moment(data, ids, n, order, mask))


@pytest.mark.parametrize("relu_clamp", [True, False])
def test_segment_var_clamp_matches_jax(relu_clamp):
    data, ids, mask, n = _segment_inputs(seed=7)
    data[ids == 2] = 0.1                         # equal messages: var_raw ~ 0
    got = tseg.segment_var(torch.from_numpy(data), torch.from_numpy(ids), n,
                           torch.from_numpy(mask), relu_clamp=relu_clamp)
    want = jseg.segment_var(data, ids, n, mask, relu_clamp=relu_clamp)
    _close(got, want)
    if relu_clamp:
        assert bool((got >= 0).all())


@pytest.mark.parametrize("name", ALL_AGGS)
def test_segment_aggregator_matches_jax(name):
    """Every aggregator of the bank, on edge messages of a padded batch with
    an isolated node, against its JAX twin, with the self messages and
    senders its context carries."""
    tg, jg = _graphs(_records())
    rng = np.random.RandomState(1)
    msg = rng.randn(tg.n_edge_pad, 6).astype(np.float32)
    self_msg = rng.randn(tg.n_node_pad, 6).astype(np.float32)
    ctx = tagg.SegmentCtx.create(
        torch.from_numpy(msg), tg.receivers, tg.n_node_pad, tg.edge_mask,
        senders=tg.senders, self_msg=torch.from_numpy(self_msg))
    jctx = jagg.SegmentCtx.create(
        msg, np.asarray(jg.receivers), jg.n_node_pad, np.asarray(jg.edge_mask),
        senders=np.asarray(jg.senders), self_msg=self_msg)
    got = tagg.SEGMENT_AGGREGATORS[name](ctx)
    want = jagg.SEGMENT_AGGREGATORS[name](jctx)
    assert got.shape == (tg.n_node_pad, 6)
    _close(got, want, atol=MOMENT_ATOL if name.startswith('moment') else 1e-6,
           msg=name)
    assert bool(torch.isfinite(got).all())


def test_scalers_match_jax_exactly():
    """Each scaler on X [N, 3, F] with deg [N], and the stacked weights of
    scaler_weights against the scalers applied to ones."""
    rng = np.random.RandomState(2)
    deg = rng.randint(0, 6, 40).astype(np.float32)
    x = rng.randn(40, 3, 7).astype(np.float32)
    for name, fn in tscal.SCALERS.items():
        got = fn(torch.from_numpy(x), torch.from_numpy(deg)[:, None], AVG_D)
        want = jscal.SCALERS[name](x, deg[:, None], AVG_D)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
        flat = fn(torch.from_numpy(x[:, 0]), torch.from_numpy(deg), AVG_D)
        np.testing.assert_array_equal(
            flat.numpy(), np.asarray(jscal.SCALERS[name](x[:, 0], deg,
                                                         AVG_D)), name)
    w = tscal.scaler_weights(tuple(tscal.SCALERS), torch.from_numpy(deg),
                             AVG_D)
    ones = torch.ones(40)
    for i, fn in enumerate(tscal.SCALERS.values()):
        assert torch.equal(w[i], fn(ones, torch.from_numpy(deg), AVG_D))
    with pytest.raises(ValueError):
        tscal.scaler_weights(('cubic',), torch.from_numpy(deg), AVG_D)


def test_avg_d_from_degree_hist_matches_jax_exactly():
    hist = np.array([3, 40, 55, 21, 4, 0, 1, 0, 0, 2])
    assert tscal.avg_d_from_degree_hist(hist) == \
        jscal.avg_d_from_degree_hist(hist)


def test_graph_helpers_match_jax():
    """in_degrees, out_degrees, nodes_per_graph; build_graph; and
    sort_by_receiver restores the collated order and edge_ptr after a
    shuffle of the edges."""
    recs = _records(4, seed=3)
    tg, jg = _graphs(recs)
    for name in ('in_degrees', 'out_degrees', 'nodes_per_graph'):
        np.testing.assert_array_equal(getattr(tg, name)().numpy(),
                                      np.asarray(getattr(jg, name)()), name)
    r = recs[1]
    for pad in (None, 32):
        a = tgraph.build_graph(r['node_feats'], r['senders'], r['receivers'],
                               r['edge_feats'], n_node_pad=pad)
        b = jgraph.build_graph(r['node_feats'], r['senders'], r['receivers'],
                               r['edge_feats'], n_node_pad=pad)
        assert a.n_graph_pad == b.n_graph_pad and a.n_node_pad == b.n_node_pad
        np.testing.assert_array_equal(a.node_graph_ids.numpy(),
                                      np.asarray(b.node_graph_ids))
        np.testing.assert_array_equal(a.in_degrees().numpy(),
                                      np.asarray(b.in_degrees()))
    perm = torch.from_numpy(np.random.RandomState(0).permutation(
        tg.n_edge_pad))
    shuffled = tgraph.Graph(**{**tg.__dict__, **{
        k: getattr(tg, k)[perm] for k in ('senders', 'receivers', 'edge_mask',
                                          'edge_feats', 'snorm_e')}})
    back = tgraph.sort_by_receiver(shuffled)
    assert torch.equal(back.edge_ptr, tg.edge_ptr)
    assert torch.equal(back.receivers, tg.receivers)
    want = jgraph.sort_by_receiver(jg.replace(
        senders=np.asarray(jg.senders)[perm.numpy()],
        receivers=np.asarray(jg.receivers)[perm.numpy()],
        edge_mask=np.asarray(jg.edge_mask)[perm.numpy()],
        edge_feats=np.asarray(jg.edge_feats)[perm.numpy()],
        snorm_e=np.asarray(jg.snorm_e)[perm.numpy()]))
    for k in ('senders', 'receivers', 'edge_mask', 'edge_feats', 'snorm_e'):
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      np.asarray(getattr(want, k)), k)


def test_aggregate_bank_matches_jax():
    """The bank with identity and normalised_mean besides the moments and
    softmax: aggregators on the feature axis, then a block per scaler; the
    scalers' degree is the raw in-degree (0 on the isolated node)."""
    tg, jg = _graphs(_records(seed=4))
    rng = np.random.RandomState(5)
    msg = rng.randn(tg.n_edge_pad, 3).astype(np.float32)
    self_msg = rng.randn(tg.n_node_pad, 3).astype(np.float32)
    aggs = ('mean', 'identity', 'normalised_mean', 'max', 'softmax', 'std',
            'moment3')
    got = tsparse.aggregate_bank(tg, torch.from_numpy(msg), aggs, SCAL, AVG_D,
                                 self_msg=torch.from_numpy(self_msg))
    want = jsparse.aggregate_bank(jg, msg, aggs, SCAL, AVG_D,
                                  self_msg=self_msg)
    assert got.shape == (tg.n_node_pad, len(SCAL) * len(aggs) * 3)
    _close(got, want)


def test_csr_bank_unclamped_var():
    """A node whose messages are all equal has var_raw = E[x^2] - E[x]^2
    slightly negative in float32.  The bank with relu_clamp=False gives that
    value and its full gradient, as segment_var(relu_clamp=False) does; the
    clamped bank gives 0 and no var gradient there; std clamps either way."""
    v = next(x for x in np.linspace(0.1, 3.0, 300, dtype=np.float32)
             if float(torch.tensor([x] * 3).square().sum() / 3
                      - (torch.tensor([x] * 3).sum() / 3) ** 2) < 0)
    msg = np.random.RandomState(6).randn(10, 4).astype(np.float32)
    msg[3:6] = v                                   # node 1: three equal rows
    ptr = torch.tensor([0, 3, 6, 10, 10], dtype=torch.int32)
    ids = torch.tensor([0] * 3 + [1] * 3 + [2] * 4)
    layout = csr_bank.csr_layout(ptr, torch.ones(10, dtype=torch.bool))
    for clamp in (False, True):
        m = torch.from_numpy(msg).requires_grad_(True)
        z = csr_bank.csr_raw_bank(m, layout, ('var', 'std'), relu_clamp=clamp)
        z.sum().backward()
        m2 = torch.from_numpy(msg).requires_grad_(True)
        want = tseg.segment_var(m2, ids, 4, relu_clamp=clamp)
        (want.sum() + tseg.segment_std(m2, ids, 4).sum()).backward()
        assert torch.equal(z[:, 0].detach(), want.detach())
        assert bool((z[1, 0] < 0).all() if not clamp
                    else (z[1, 0] == 0).all())
        torch.testing.assert_close(m.grad, m2.grad, rtol=1e-5, atol=1e-6)
    # the backward's node fields: var's gradient reaches node 1 unclamped
    # and is cut there clamped
    s, sq, mx, mn, tmx, tmn = csr_bank.csr_moment_sketch(
        torch.from_numpy(msg), ptr, True)
    _, (mean, var_raw, std) = csr_bank._assemble(('var',), s, sq, mx, mn,
                                                 layout.cnt)
    ones = torch.ones(4, 1, 4)
    for clamp in (False, True):
        g_lin, g_quad, _, _ = csr_bank.node_fields(
            ('var',), ones, layout.cnt, mean, var_raw, std, tmx, tmn, clamp)
        assert bool((g_quad[1] == 0).all()) == clamp


# ---- layers -----------------------------------------------------------

def _grad_close(grads, want, what):
    """Every gradient within 1e-4 of the largest entry of all of them."""
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        g = grads[k]
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * scale, f"{what} {k}: {err} of {scale}"


def _compare_layer(jmod, tmod_fn, tg, jg, h, e, kw_fn, has_train=True):
    """Forward and every gradient (parameters and h) of a flax layer and the
    port's layer on the same weights, in training mode (batch statistics;
    ``has_train``: the flax layer takes ``train``), with loss
    sum(sin(out) * node_mask)."""
    m = np.asarray(jg.node_mask, np.float32)[:, None]
    jargs = kw_fn(jg, h, e)
    var = _np(jax.jit(lambda a: jmod.init(
        {'params': jax.random.PRNGKey(0)}, *a,
        **({'train': False} if has_train else {})))(jargs))

    def lf(p, hh):
        args = kw_fn(jg, hh, e)
        vs = dict(var, params=p)
        if has_train:
            out, _ = jmod.apply(vs, *args, train=True,
                                mutable=['batch_stats'])
        else:
            out = jmod.apply(vs, *args)
        return jnp.sum(jnp.sin(out) * m), out

    (_, out_j), (gp, gh) = jax.jit(jax.value_and_grad(
        lf, argnums=(0, 1), has_aux=True))(var['params'], h)
    tmod = tmod_fn()
    tmod.load_state_dict(from_jax(var['params'], var.get('batch_stats')))
    tmod.train()
    ht = torch.from_numpy(h).requires_grad_(True)
    et = None if e is None else tg.edge_feats
    out = tmod(*kw_fn(tg, ht, et))
    (torch.sin(out) * torch.from_numpy(m)).sum().backward()
    _close(out.detach(), out_j, rtol=1e-5, atol=1e-5)
    want = {k: v.numpy() for k, v in from_jax(_np(gp)).items()}
    want['h'] = np.asarray(gh)
    got = {k: p.grad.numpy() for k, p in tmod.named_parameters()}
    got['h'] = ht.grad.numpy()
    assert set(got) == set(want)
    _grad_close(got, want, type(tmod).__name__)
    return tmod


def _node_h(tg):
    return tg.node_feats.numpy().astype(np.float32)


@pytest.mark.parametrize("edge", [False, True])
def test_tower_matches_jax(edge):
    tg, jg = _graphs(_records(seed=8))
    aggs = ('mean', 'max', 'identity', 'softmin', 'std')
    kw = dict(aggregators=aggs, scalers=SCAL, avg_d=AVG_D, graph_norm=True,
              batch_norm=True, pretrans_layers=2, posttrans_layers=2,
              edge_features=edge)
    jmod = jsparse.PNATowerSparse(out_dim=6, **kw)
    _compare_layer(
        jmod, lambda: tsparse.PNATowerSparse(F_IN, 6, **kw, edge_dim=FE,
                                             device='cpu'),
        tg, jg, _node_h(tg), tg.edge_feats.numpy() if edge else None,
        lambda g, h, e: (g, h, e))


@pytest.mark.parametrize("towers", [1, 5])
@pytest.mark.parametrize("edge", [False, True])
def test_layer_sparse_matches_jax(towers, edge):
    tg, jg = _graphs(_records(seed=9))
    kw = dict(aggregators=AGGS, scalers=SCAL, avg_d=AVG_D, graph_norm=True,
              batch_norm=True, towers=towers, divide_input=True,
              residual=True, edge_features=edge)
    jmod = jsparse.PNALayerSparse(out_dim=F_IN, **kw)
    tmod = _compare_layer(
        jmod, lambda: tsparse.PNALayerSparse(F_IN, F_IN, **kw, edge_dim=FE,
                                             device='cpu'),
        tg, jg, _node_h(tg), tg.edge_feats.numpy() if edge else None,
        lambda g, h, e: (g, h, e))
    assert tmod.residual and hasattr(tmod, f'tower_{towers - 1}')


def test_simple_layer_matches_jax():
    tg, jg = _graphs(_records(seed=10, fe=0))
    kw = dict(aggregators=AGGS + ('var', 'sum'), scalers=SCAL, avg_d=AVG_D,
              batch_norm=True, residual=True, posttrans_layers=2)
    _compare_layer(
        jsparse.PNASimpleLayerSparse(out_dim=F_IN, **kw),
        lambda: tsparse.PNASimpleLayerSparse(F_IN, F_IN, **kw, device='cpu'),
        tg, jg, _node_h(tg), None, lambda g, h, e: (g, h))
    with pytest.raises(ValueError, match="identity"):
        tsparse.PNASimpleLayerSparse(4, 4, ('identity',), SCAL, AVG_D,
                                     device='cpu')


@pytest.mark.parametrize("edge", [False, True])
def test_conv_pyg_matches_jax(edge):
    """PNAConvPyG with 2 towers (divided input) and PyG's unclamped var."""
    tg, jg = _graphs(_records(seed=11))
    aggs = ('mean', 'var', 'max', 'std')
    kw = dict(aggregators=aggs, scalers=SCAL + ('linear',), towers=2,
              pre_layers=2, post_layers=2, divide_input=True)
    jmod = jpyg.PNAConvPyG(out_channels=8, avg_deg=AVG_D,
                           edge_dim=FE if edge else None, **kw)
    _compare_layer(
        jmod, lambda: tpyg.PNAConvPyG(F_IN, 8, avg_deg=AVG_D,
                                      edge_dim=FE if edge else None, **kw,
                                      device='cpu'),
        tg, jg, _node_h(tg), tg.edge_feats.numpy() if edge else None,
        lambda g, h, e: (g, h, e), has_train=False)


def test_conv_simple_pyg_matches_jax():
    tg, jg = _graphs(_records(seed=12, fe=0))
    kw = dict(aggregators=('mean', 'min', 'max', 'std', 'var', 'sum'),
              scalers=SCAL + ('inverse_linear',), post_layers=2)
    _compare_layer(
        jpyg.PNAConvSimplePyG(out_channels=7, avg_deg=AVG_D, **kw),
        lambda: tpyg.PNAConvSimplePyG(F_IN, 7, avg_deg=AVG_D, **kw,
                                      device='cpu'),
        tg, jg, _node_h(tg), None, lambda g, h, e: (g, h), has_train=False)
    with pytest.raises(ValueError, match="softmax"):
        tpyg.PNAConvSimplePyG(4, 4, ('softmax',), SCAL, AVG_D, device='cpu')


def test_molecules_unfused_towers_match_jax():
    """PNANetMolecules(fused_towers=False): the PNALayerSparse stack with
    edge features, towers 2, the GRU between layers; loss and every
    gradient against the JAX net."""
    from pna_tpu.data import molecules as jmol
    from pna_tpu_torch.data import molecules as tmol
    recs = tmol.synthetic_zinc(12, seed=1)
    tg, labels = tmol.collate_records(recs)
    jg, _ = jmol.collate_records(recs)
    kw = dict(num_atom_type=28, num_bond_type=4, hidden_dim=8, out_dim=8,
              n_layers=2, aggregators=AGGS, scalers=SCAL, avg_d=AVG_D,
              towers=2, divide_input_first=True, edge_feat=True, edge_dim=4,
              gru_enable=True, fused_towers=False)
    jnet = JMolecules(**kw)
    args = (jg, jg.node_feats.squeeze(-1), jg.edge_feats.squeeze(-1))
    var = _np(jax.jit(lambda a: jnet.init({'params': jax.random.PRNGKey(0)},
                                          *a, train=False))(args))

    def lf(p):
        out, _ = jnet.apply(dict(var, params=p), *args, train=True,
                            mutable=['batch_stats'])
        return JMolecules.loss(out, jnp.asarray(labels.numpy()),
                               jg.graph_mask)

    l_j, g_j = jax.jit(jax.value_and_grad(lf))(var['params'])
    net = PNANetMolecules(**kw, device='cpu')
    net.load_state_dict(from_jax(var['params'], var['batch_stats']))
    net.train()
    loss = PNANetMolecules.loss(net(tg, tg.node_feats.squeeze(-1),
                                    tg.edge_feats.squeeze(-1)), labels,
                                tg.graph_mask)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-5)
    assert isinstance(net.layers[0], tsparse.PNALayerSparse)
    _grad_close({k: p.grad.numpy() for k, p in net.named_parameters()},
                {k: v.numpy() for k, v in from_jax(_np(g_j)).items()},
                'PNANetMolecules(fused_towers=False)')
    with pytest.raises(ValueError, match="float32"):
        PNANetMolecules(**kw, compute_dtype=torch.bfloat16, device='cpu')
