"""PNANetMolecules of the port against the JAX net (interpret mode), at L=2
and narrow widths with the weights carried across by weights.from_jax:
kernel='csr' against the JAX kernel='pallas' and kernel='csr_fused' against
the JAX kernel='pallas_fused': forward, loss and every gradient, then three
Adam steps against optax.adam; compute_dtype=bfloat16 on both backends
against the JAX bfloat16 net; and the entry() twin against
__graft_entry__.entry().

Tolerances: outputs and loss rtol 1e-4; gradients rtol 2e-4, atol 2e-5.
After the Adam steps the parameters may differ by up to 2 * lr per step: an
entry whose gradient is ~0 takes the update m / (sqrt(v) + eps), which turns
float32 noise of either sign into a step of up to lr, so the bound is
3 steps * 2 * lr = 6e-3; nearly all entries agree far more closely, and the
test checks that as well.

bfloat16: the loss within rtol 1e-2 and every gradient tensor within 5e-2 of
its norm, for the reasons tests/test_torch_fused_layer.py gives: both sides
round the same operands, sum in float32 in other orders, and a rounding that
lands the other side of a bfloat16 boundary moves a value by 2^-8 of itself
(or, where bfloat16 messages tie, a max/min gradient to another edge)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pna_tpu.data import molecules as jmol
from pna_tpu.nn.nets import PNANetMolecules as JNet
from pna_tpu_torch import entry as t_entry
from pna_tpu_torch.data import molecules as tmol
from pna_tpu_torch.nn.nets import PNANetMolecules
from pna_tpu_torch.train.step import loss_and_grads, make_optimizer, train_step
from pna_tpu_torch.weights import from_jax

LR = 1e-3
AGGS = ('mean', 'max', 'min', 'std')
SCALERS = ('identity', 'amplification', 'attenuation')


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(edge_feat):
    if edge_feat:      # the flagship's shape, narrowed
        kw = dict(hidden_dim=10, out_dim=8, edge_dim=4, edge_feat=True,
                  divide_input_first=True, divide_input_last=True)
    else:              # entry()'s shape, narrowed: shared tower inputs
        kw = dict(hidden_dim=10, out_dim=8, edge_dim=0, edge_feat=False,
                  divide_input_first=False, divide_input_last=True)
    return dict(kw, num_atom_type=28, num_bond_type=4, n_layers=2,
                aggregators=AGGS, scalers=SCALERS, readout_type='sum',
                towers=2, graph_norm=True, batch_norm=True, residual=True)


JAX_KERNEL = {'csr': 'pallas', 'csr_fused': 'pallas_fused'}


def _setup(edge_feat, n_graphs=6, kernel='csr', cdt=torch.float32,
           **net_kw):
    recs = tmol.synthetic_zinc(n_graphs, seed=11)
    tg, tl = tmol.collate_records(recs)
    jg, jl = jmol.collate_records(jmol.synthetic_zinc(n_graphs, seed=11))
    avg_d = tmol.ZincDataset(recs, [], []).avg_d()
    kw = dict(_configs(edge_feat), avg_d=avg_d, **net_kw)
    jnet = JNet(**kw, kernel=JAX_KERNEL[kernel], pallas_interpret=True,
                compute_dtype=jnp.bfloat16 if cdt == torch.bfloat16 else None)
    e_idx = jg.edge_feats.squeeze(-1) if edge_feat else None
    var = _np(jnet.init({'params': jax.random.PRNGKey(0)}, jg,
                        jg.node_feats.squeeze(-1), e_idx, train=False))
    tnet = PNANetMolecules(**kw, kernel=kernel, compute_dtype=cdt,
                           device='cpu')
    tnet.load_state_dict(from_jax(var['params'], var['batch_stats']))
    return tg, tl, jg, jl, jnet, var, tnet, e_idx


def _jax_loss_fn(jnet, jg, jl, e_idx):
    def loss_fn(p, stats):
        out, mut = jnet.apply({'params': p, 'batch_stats': stats}, jg,
                              jg.node_feats.squeeze(-1), e_idx, train=True,
                              mutable=['batch_stats'])
        return JNet.loss(out, jnp.asarray(jl), jg.graph_mask), (
            out, mut['batch_stats'])
    return loss_fn


def _check_net(edge_feat, kernel, **net_kw):
    tg, tl, jg, jl, jnet, var, tnet, e_idx = _setup(edge_feat, kernel=kernel,
                                                    **net_kw)
    (l_j, (out_j, stats_j)), g_j = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jnet, jg, jl, e_idx), has_aux=True))(
            var['params'], var['batch_stats'])

    l_t = loss_and_grads(tnet, tg, tl)
    tnet.eval()
    with torch.no_grad():      # eval-mode forward after the update
        out_eval = tnet(tg, tg.node_feats.squeeze(-1),
                        tg.edge_feats.squeeze(-1) if edge_feat else None)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-4)
    want = from_jax(_np(g_j))
    got = dict(tnet.named_parameters())
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), w.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    for k, w in from_jax({}, _np(stats_j)).items():
        np.testing.assert_allclose(tnet.state_dict()[k].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    out_je = jnet.apply({'params': var['params'], 'batch_stats': stats_j},
                        jg, jg.node_feats.squeeze(-1), e_idx, train=False)
    np.testing.assert_allclose(out_eval.numpy(), np.asarray(out_je),
                               rtol=1e-4, atol=1e-5)
    assert out_eval.shape == (tg.n_graph_pad, 1)


@pytest.mark.parametrize("edge_feat", [True, False])
def test_net_forward_loss_grads_match_jax(edge_feat):
    _check_net(edge_feat, 'csr')


@pytest.mark.parametrize("edge_feat", [True, False])
def test_csr_fused_net_matches_jax(edge_feat):
    """kernel='csr_fused' (K3/K4) against the JAX kernel='pallas_fused'."""
    _check_net(edge_feat, 'csr_fused')


def test_gru_and_two_layer_mlps_net_matches_jax():
    """gru_enable (one GRU shared between the layers, none after the last)
    with pretrans_layers=2 and posttrans_layers=2, on 'csr' against the JAX
    'pallas' net: forward, loss, every gradient (the GRU's in torch's gate
    layout) and the eval-mode output, at the tolerances above."""
    _check_net(True, 'csr', gru_enable=True, pretrans_layers=2,
               posttrans_layers=2)


# the ids are the cases' names from when the message cited the ROADMAP item
@pytest.mark.parametrize("kw,item", [
    (dict(kernel='generic', compute_dtype=torch.float16), "nor any CLI"),
    (dict(remat=True, compute_dtype=torch.float16), "nor any CLI")],
    ids=["kw0-item 7", "kw1-item 7"])
def test_unported_net_options_raise(kw, item):
    """Every backend and remat are ported; a float16 compute dtype is not,
    with any of them: neither bench.py, its twin nor a CLI runs it."""
    with pytest.raises(NotImplementedError, match=item):
        PNANetMolecules(**_configs(True), avg_d={'log': 1.0}, device='cpu',
                        **kw)


def test_unfused_towers_stack_sparse_layers():
    """fused_towers=False stacks PNALayerSparse (float32 only); its parity
    with the JAX net is tests/test_torch_sparse.py's."""
    from pna_tpu_torch.nn.sparse import PNALayerSparse
    net = PNANetMolecules(**_configs(True), avg_d={'log': 1.0, 'lin': 2.0},
                          device='cpu', fused_towers=False)
    assert all(isinstance(layer, PNALayerSparse) for layer in net.layers)
    with pytest.raises(ValueError, match="float32"):
        PNANetMolecules(**_configs(True), avg_d={'log': 1.0}, device='cpu',
                        fused_towers=False, compute_dtype=torch.bfloat16)


def test_net_dropout_follows_generator_and_mode():
    """in_feat_dropout and dropout: eval mode gives the no-dropout output;
    training repeats with the generator's seed and differs from the
    no-dropout output."""
    tg, tl, _, _, _, var, tnet, _ = _setup(True)
    kw = dict(_configs(True), avg_d=tmol.ZincDataset(
        tmol.synthetic_zinc(6, seed=11), [], []).avg_d())
    drop = PNANetMolecules(**kw, dropout=0.3, in_feat_dropout=0.2,
                           device='cpu', seed=4)
    drop.load_state_dict(tnet.state_dict())
    args = (tg, tg.node_feats.squeeze(-1), tg.edge_feats.squeeze(-1))
    tnet.eval()
    drop.eval()
    with torch.no_grad():
        assert torch.equal(drop(*args), tnet(*args))
        drop.train()
        tnet.train()
        base = tnet(*args)
        # training mode moves the batch-norm statistics (the shift of the
        # next call): restore them before the second draw
        before = {k: v.clone() for k, v in drop.state_dict().items()}
        drop.generator.manual_seed(9)
        a = drop(*args)
        drop.load_state_dict(before)
        drop.generator.manual_seed(9)
        b = drop(*args)
    assert torch.equal(a, b)
    assert float((a - base).abs().max()) > 1e-3


@pytest.mark.parametrize("kernel", ['csr', 'csr_fused'])
def test_bf16_net_matches_jax_bf16(kernel):
    """compute_dtype=bfloat16, the flagship's shape narrowed: loss and every
    gradient against the JAX bfloat16 net on the same weights."""
    tg, tl, jg, jl, jnet, var, tnet, e_idx = _setup(True, kernel=kernel,
                                                    cdt=torch.bfloat16)
    (l_j, _), g_j = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jnet, jg, jl, e_idx), has_aux=True))(
            var['params'], var['batch_stats'])
    l_t = loss_and_grads(tnet, tg, tl)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-2)
    got = dict(tnet.named_parameters())
    for k, w in from_jax(_np(g_j)).items():
        g, w = got[k].grad.numpy(), w.numpy()
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 5e-2, (k, err)


def test_adam_steps_match_optax():
    tg, tl, jg, jl, jnet, var, tnet, e_idx = _setup(True)
    grad_fn = jax.jit(jax.value_and_grad(_jax_loss_fn(jnet, jg, jl, e_idx),
                                         has_aux=True))
    tx = optax.adam(LR)
    params, stats = var['params'], var['batch_stats']
    opt_state = tx.init(params)
    opt = make_optimizer(tnet, lr=LR)
    for step in range(3):
        (l_j, (_, stats)), grads = grad_fn(params, stats)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        l_t = train_step(tnet, opt, tg, tl)
        np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-4,
                                   err_msg=f"step {step}")
    want = from_jax(_np(params), _np(stats))
    sd = tnet.state_dict()
    diffs = []
    for k, w in want.items():
        d = np.abs(sd[k].numpy() - w.numpy())
        assert d.max() <= 3 * 2 * LR, k
        diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.quantile(diffs, 0.99) < 1e-5


def test_entry_twin_matches_jax_entry():
    """entry('cpu') against __graft_entry__.entry(): the same no-edge-feature
    flagship, same batch, same weights -> same eval-mode scores."""
    import __graft_entry__ as g
    j_forward, (j_vars, j_graph) = g.entry()
    forward, (model, graph) = t_entry('cpu')
    model.load_state_dict(from_jax(_np(j_vars['params']),
                                   _np(j_vars['batch_stats'])))
    got = forward(model, graph)
    want = np.asarray(j_forward(j_vars, j_graph))
    assert got.shape == want.shape == (33, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
