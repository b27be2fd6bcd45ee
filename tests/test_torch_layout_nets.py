"""The nets on the receiver-sorted batch against pna_tpu's nets on its
bucketed and ELL batches of the same records, on the CPU, on the same
weights (weights.from_jax): PNANetMolecules against the JAX net under
``kernel='auto'`` on a bucketed batch (float32 and bfloat16), ``'ell'`` and
``'generic'`` (with ``identity``), the port held on ``csr`` (its plain
versions here), or ``generic`` where ``identity`` needs it; the port's
``csr`` loss against the JAX bucketed and ELL losses in eval mode; and
PNANetHIV against the JAX net on an ELL batch.  The port has no bucketed or
ELL layout; the outputs compared are per graph, which no node order moves.

Tolerances: float32 loss rtol 1e-4 and every gradient tensor within 2e-3 of
its scale: its largest entry, but at least 1e-3 of the model's largest
gradient entry, as chip_smoke.py holds the trainers' steps (a bias before a
batch norm has a gradient that is 0 but for float noise; the JAX batches of
the generic case take the ELL path, the port's the segment form, and both
sides sum in other orders); bfloat16 loss rtol 1e-2 and every gradient
within 5e-2 of its norm.  tests/test_torch_layout_remat.py holds remat with
these helpers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu.data import molecules as jmol
from pna_tpu.nn.nets import PNANetHIV as JHIV
from pna_tpu.nn.nets import PNANetMolecules as JNet
from pna_tpu_torch.data import hiv as thiv
from pna_tpu_torch.data import molecules as tmol
from pna_tpu_torch.nn.nets import PNANetHIV, PNANetMolecules
from pna_tpu_torch.train.step import loss_and_grads
from pna_tpu_torch.weights import from_jax

AGGS = ('mean', 'max', 'min', 'std')
SCALERS = ('identity', 'amplification', 'attenuation')
NET = dict(num_atom_type=28, num_bond_type=4, hidden_dim=16, out_dim=16,
           n_layers=2, scalers=SCALERS, readout_type='sum', towers=2,
           graph_norm=True, batch_norm=True, residual=True, edge_feat=True,
           edge_dim=4)
# the JAX batch layout of each case, its collate_records arguments (the
# JAX batcher builds ELL by default), and the port's backend on its CSR
# batch
LAYOUT = {'auto': dict(bucket_by_degree=True), 'ell': dict(),
          'generic': dict()}
PORT_KERNEL = {'auto': 'csr', 'ell': 'csr', 'generic': 'generic'}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(layout_kw, n=8, seed=11):
    """The port's CSR batch and the JAX batch in ``layout_kw``'s layout."""
    recs = tmol.synthetic_zinc(n, seed=seed)
    tg, tl = tmol.collate_records(recs)
    jg, jl = jmol.collate_records(jmol.synthetic_zinc(n, seed=seed),
                                  **layout_kw)
    return recs, tg, tl, jg, jl


def _jax_step(jnet, jg, jl):
    e_idx = jg.edge_feats.squeeze(-1)
    var = _np(jnet.init({'params': jax.random.PRNGKey(0)}, jg,
                        jg.node_feats.squeeze(-1), e_idx, train=False))

    def loss_fn(p):
        out, mut = jnet.apply({'params': p,
                               'batch_stats': var['batch_stats']}, jg,
                              jg.node_feats.squeeze(-1), e_idx, train=True,
                              mutable=['batch_stats'])
        return JNet.loss(out, jnp.asarray(jl), jg.graph_mask), \
            mut['batch_stats']

    (l_j, stats_j), g_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(var['params'])
    return var, float(l_j), from_jax(_np(g_j)), from_jax({}, _np(stats_j))


def _hold(net, l_t, l_j, grads_j, bf16=False):
    np.testing.assert_allclose(float(l_t), l_j, rtol=1e-2 if bf16 else 1e-4)
    got = dict(net.named_parameters())
    assert set(got) == set(grads_j)
    floor = 1e-3 * max(float(np.abs(w.numpy()).max())
                       for w in grads_j.values())
    for k, w in grads_j.items():
        g, w = got[k].grad.numpy(), w.numpy()
        if bf16:
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= 5e-2, (k, err)
        else:
            err = np.abs(g - w).max() / max(np.abs(w).max(), floor)
            assert err <= 2e-3, (k, err)


@pytest.mark.parametrize("kernel,cdt", [
    ('auto', torch.float32), ('auto', torch.bfloat16),
    ('ell', torch.float32), ('generic', torch.float32)])
def test_net_on_layout_matches_jax(kernel, cdt):
    recs, tg, tl, jg, jl = _batches(LAYOUT[kernel])
    aggs = AGGS + ('identity',) if kernel == 'generic' else AGGS
    avg_d = tmol.ZincDataset(recs, [], []).avg_d()
    bf16 = cdt == torch.bfloat16
    jnet = JNet(**NET, aggregators=aggs, avg_d=avg_d, kernel=kernel,
                compute_dtype=jnp.bfloat16 if bf16 else None)
    var, l_j, g_j, stats_j = _jax_step(jnet, jg, jl)
    net = PNANetMolecules(**NET, aggregators=aggs, avg_d=avg_d,
                          kernel=PORT_KERNEL[kernel], compute_dtype=cdt,
                          device='cpu')
    net.load_state_dict(from_jax(var['params'], var['batch_stats']))
    _hold(net, loss_and_grads(net, tg, tl), l_j, g_j, bf16)
    if not bf16:
        for k, w in stats_j.items():
            np.testing.assert_allclose(net.state_dict()[k].numpy(),
                                       w.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_auto_bucketed_loss_equals_csr_loss():
    """The same weights and records: the port's CSR batch under 'csr' gives
    the JAX net's eval loss on the bucketed batch under 'auto' and on the
    ELL batch under 'ell' (one function, three layouts)."""
    recs = tmol.synthetic_zinc(8, seed=11)
    avg_d = tmol.ZincDataset(recs, [], []).avg_d()
    g, y = tmol.collate_records(recs)
    net = PNANetMolecules(**NET, aggregators=AGGS, avg_d=avg_d,
                          device='cpu')
    var = None
    losses = []
    for kernel in ('auto', 'ell'):
        jg, jl = jmol.collate_records(jmol.synthetic_zinc(8, seed=11),
                                      **LAYOUT[kernel])
        jnet = JNet(**NET, aggregators=AGGS, avg_d=avg_d, kernel=kernel)
        args = (jg, jg.node_feats.squeeze(-1), jg.edge_feats.squeeze(-1))
        if var is None:
            var = _np(jnet.init({'params': jax.random.PRNGKey(0)}, *args,
                                train=False))
        out = jnet.apply(var, *args, train=False)
        losses.append(float(JNet.loss(out, jnp.asarray(jl), jg.graph_mask)))
    net.load_state_dict(from_jax(var['params'], var['batch_stats']))
    net.eval()
    with torch.no_grad():
        out = net(g, g.node_feats.squeeze(-1), g.edge_feats.squeeze(-1))
    loss = float(PNANetMolecules.loss(out, y, g.graph_mask))
    np.testing.assert_allclose(losses, loss, rtol=1e-5)


def test_hiv_net_on_ell_batch_matches_jax():
    """PNANetHIV with an isolated atom: the JAX bank takes its ELL path,
    the port's the segment form on the CSR batch."""
    recs = thiv.synthetic_molhiv(24, seed=0)
    r = dict(recs[0])
    r['node_feats'] = np.concatenate([r['node_feats'], r['node_feats'][:1]])
    recs[0] = r
    tg, tl = tmol.collate_records(recs)
    jg, jl = jmol.collate_records(recs)
    assert jg.nbr_edge_ids is not None
    assert int(tg.in_degrees()[tg.node_mask].min()) == 0
    avg_d = thiv.HIVDataset(recs, [], []).avg_d()
    kw = dict(hidden_dim=16, out_dim=16, n_layers=2, aggregators=AGGS,
              scalers=SCALERS, avg_d=avg_d)
    jnet = JHIV(**kw)
    var = _np(jnet.init({'params': jax.random.PRNGKey(0)}, jg,
                        jg.node_feats, train=False))

    def lf(p):
        out, _ = jnet.apply(dict(var, params=p), jg, jg.node_feats,
                            train=True, mutable=['batch_stats'])
        return JHIV.loss(out, jnp.asarray(jl), jg.graph_mask)

    l_j, g_j = jax.jit(jax.value_and_grad(lf))(var['params'])
    net = PNANetHIV(**kw, device='cpu')
    net.load_state_dict(from_jax(var['params'], var['batch_stats']))
    net.train()
    loss = PNANetHIV.loss(net(tg, tg.node_feats), tl, tg.graph_mask)
    loss.backward()
    _hold(net, loss.detach(), float(l_j), from_jax(_np(g_j)))

