"""Building blocks of the port against pna_tpu: MaskedBatchNorm (train and
eval, running statistics, gradients), MLPReadout, the readouts, the segment
ops and the scaler weights.  Tolerance rtol 1e-5, atol 1e-6 unless noted
(float32 on both sides, sums in other orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu.graph import batch_graphs as j_batch_graphs
from pna_tpu.nn.layers import MLPReadout as JMLPReadout
from pna_tpu.nn.sparse import MaskedBatchNorm as JMaskedBatchNorm
from pna_tpu.ops import readout as jreadout
from pna_tpu.ops import segment as jseg
from pna_tpu.ops.fused_vjp import _scaler_weights
from pna_tpu_torch.graph import batch_graphs
from pna_tpu_torch.nn import layers as tlayers
from pna_tpu_torch.nn.sparse import MaskedBatchNorm
from pna_tpu_torch.ops import readout as treadout
from pna_tpu_torch.ops import segment as tseg
from pna_tpu_torch.ops.scalers import scaler_weights
from pna_tpu_torch.weights import from_jax

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_masked_batchnorm_train_and_eval():
    rng = np.random.RandomState(0)
    n, f = 40, 6
    x = (rng.randn(n, f) * 3 + 5).astype(np.float32)
    mask = rng.rand(n) < 0.7
    x[~mask] = 1e4                         # padded rows must not count
    bn = JMaskedBatchNorm()
    params = {'scale': rng.rand(f).astype(np.float32) + 0.5,
              'bias': rng.randn(f).astype(np.float32)}
    stats = {'mean': rng.randn(f).astype(np.float32),
             'var': rng.rand(f).astype(np.float32) + 0.5}

    def jloss(p, x):
        y, mut = bn.apply({'params': p, 'batch_stats': stats}, x,
                          jnp.asarray(mask), train=True,
                          mutable=['batch_stats'])
        return jnp.sum(jnp.where(jnp.asarray(mask)[:, None], y, 0) ** 2), (
            y, mut['batch_stats'])

    (_, (yj, new_stats)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    t = MaskedBatchNorm(f)
    t.load_state_dict(from_jax(params, stats))
    t.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    mt = torch.from_numpy(mask)
    yt = t(xt, mt)
    torch.sum(torch.where(mt[:, None], yt, 0) ** 2).backward()
    m = mask
    np.testing.assert_allclose(yt.detach().numpy()[m], np.asarray(yj)[m],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.weight.grad.numpy(), np.asarray(gp['scale']),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.bias.grad.numpy(), np.asarray(gp['bias']),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.running_mean.numpy(),
                               np.asarray(new_stats['mean']), **TOL)
    np.testing.assert_allclose(t.running_var.numpy(),
                               np.asarray(new_stats['var']), **TOL)

    # eval mode: the running statistics, no update
    t.eval()
    before = t.running_mean.clone()
    ye = t(torch.from_numpy(x), mt).detach().numpy()
    yje = bn.apply({'params': params, 'batch_stats': new_stats},
                   jnp.asarray(x), jnp.asarray(mask), train=False)
    np.testing.assert_allclose(ye, np.asarray(yje), rtol=1e-5, atol=1e-4)
    assert torch.equal(before, t.running_mean)


def test_mlp_readout_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(7, 24).astype(np.float32)
    jm = JMLPReadout(1)
    params = _np(jm.init(jax.random.PRNGKey(3), jnp.asarray(x))['params'])
    tm = tlayers.MLPReadout(24, 1, generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(from_jax(params))
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jm.apply({'params': params}, jnp.asarray(x))), **TOL)
    assert [l.out_features for l in tm.FC_layers] == [12, 6, 1]


@pytest.mark.parametrize("name", ['sum', 'mean', 'max'])
def test_readouts_match_jax(name):
    rng = np.random.RandomState(2)
    graphs = []
    for n in (3, 5, 1, 4):
        graphs.append(dict(node_feats=rng.randn(n, 2).astype(np.float32),
                           senders=np.zeros(0, np.int32),
                           receivers=np.zeros(0, np.int32)))
    tg = batch_graphs(graphs)
    jg = j_batch_graphs(graphs, with_ell=False)
    h = rng.randn(tg.n_node_pad, 5).astype(np.float32)
    got = treadout.readout(name, tg, torch.from_numpy(h)).numpy()
    want = np.asarray(jreadout.readout(name, jg, jnp.asarray(h)))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[-1] == 0)            # the padding graph is empty


@pytest.mark.parametrize("op", ['segment_sum', 'segment_mean', 'segment_max',
                                'segment_min', 'segment_var', 'segment_std'])
def test_segment_ops_match_jax(op):
    rng = np.random.RandomState(3)
    ids = np.sort(rng.randint(0, 8, 50)) * 2      # odd segments empty
    data = rng.randn(50, 3).astype(np.float32)
    mask = rng.rand(50) < 0.8
    got = getattr(tseg, op)(torch.from_numpy(data), torch.from_numpy(ids),
                            17, torch.from_numpy(mask)).numpy()
    want = np.asarray(getattr(jseg, op)(jnp.asarray(data), jnp.asarray(ids),
                                        17, jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_scaler_weights_match_jax():
    deg = np.array([0, 1, 2, 5, 0, 9], np.float32)
    avg = {'lin': 2.5, 'log': 1.1}
    names = ['identity', 'amplification', 'attenuation', 'linear',
             'inverse_linear']
    got = scaler_weights(names, torch.from_numpy(deg), avg).numpy()
    want = np.asarray(_scaler_weights(names, jnp.asarray(deg), avg))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(np.isfinite(got))


def test_initialisers_bounds_and_generator():
    g = torch.Generator().manual_seed(7)
    k = tlayers.xavier_uniform_gain(0.5)((3, 10, 6), g)
    a = 0.5 * np.sqrt(6.0 / 16)
    assert k.shape == (3, 10, 6) and float(k.abs().max()) <= a
    assert float(k.abs().max()) > 0.8 * a
    b = tlayers.torch_linear_init()((16, 4), g)
    assert float(b.abs().max()) <= 0.25
    c = tlayers.torch_linear_bias_init(25)((100,), g)
    assert float(c.abs().max()) <= 0.2
    again = tlayers.xavier_uniform_gain(0.5)(
        (3, 10, 6), torch.Generator().manual_seed(7))
    assert torch.equal(k, again)


def _fc_state(params, stats=None):
    """from_jax of a bare FCLayer: its tree is one FCLayer of an MLP."""
    sd = from_jax({'FCLayer_0': params},
                  {'FCLayer_0': stats} if stats else None)
    return {k[len('fully_connected.0.'):]: v for k, v in sd.items()}


@pytest.mark.parametrize("b_norm", [False, True])
def test_fclayer_matches_jax(b_norm):
    """Linear -> relu -> batch-norm (flax semantics: biased batch variance,
    also for the running variance), train and eval mode, and the input
    gradient; rtol 1e-5, atol 1e-5."""
    from pna_tpu.nn.layers import FCLayer as JFCLayer
    rng = np.random.RandomState(4)
    x = (rng.randn(30, 7) * 2 + 1).astype(np.float32)
    jl = JFCLayer(5, activation='relu', b_norm=b_norm)
    var = _np(jl.init(jax.random.PRNGKey(1), jnp.asarray(x)))

    def jf(xx):
        y, mut = jl.apply(var, xx, train=True, mutable=['batch_stats'])
        return jnp.sum(y * y), (y, mut)

    (_, (yj, mut)), gx = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(x))
    t = tlayers.FCLayer(7, 5, activation='relu', b_norm=b_norm)
    t.load_state_dict(_fc_state(var['params'], var.get('batch_stats')))
    t.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = t(xt)
    torch.sum(yt * yt).backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    if b_norm:
        new = _fc_state(var['params'], _np(mut['batch_stats']))
        for k in ('b_norm.running_mean', 'b_norm.running_var'):
            np.testing.assert_allclose(t.state_dict()[k].numpy(),
                                       new[k].numpy(), **tol)
        t.eval()
        ye = jl.apply({'params': var['params'], **_np(mut)},
                      jnp.asarray(x), train=False)
        np.testing.assert_allclose(t(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(ye), **tol)


def test_mlp_matches_jax():
    """Three FCLayers (relu and batch-norm in the middle, tanh last) in
    training mode; rtol 1e-5, atol 1e-5."""
    from pna_tpu.nn.layers import MLP as JMLP
    rng = np.random.RandomState(5)
    x = rng.randn(25, 6).astype(np.float32)
    jm = JMLP(hidden_size=9, out_size=4, layers=3, last_activation='tanh',
              mid_b_norm=True)
    var = _np(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    yj, _ = jm.apply(var, jnp.asarray(x), train=True,
                     mutable=['batch_stats'])
    t = tlayers.MLP(6, 9, 4, 3, last_activation='tanh', mid_b_norm=True)
    t.load_state_dict(from_jax(var['params'], var['batch_stats']))
    np.testing.assert_allclose(t(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(yj), rtol=1e-5, atol=1e-5)
    assert len(t.fully_connected) == 3


@pytest.mark.parametrize("width", [8, 5])
def test_gru_update_matches_jax(width):
    """GRUUpdate(h, y) against the JAX module (the flax cell takes the conv
    output y as its carry, the previous features h as its input), at the
    hidden width and narrower (zero-padded up to it); outputs and the
    gradients of h, y and every weight, rtol 1e-5, atol 1e-6."""
    from pna_tpu.nn.layers import GRUUpdate as JGRUUpdate
    rng = np.random.RandomState(6)
    h = rng.randn(3, 4, width).astype(np.float32)
    y = rng.randn(3, 4, width).astype(np.float32)
    jg = JGRUUpdate(hidden_size=8)
    params = _np(jg.init(jax.random.PRNGKey(3), jnp.asarray(h),
                         jnp.asarray(y))['params'])

    def jf(p, hh, yy):
        out = jg.apply({'params': p}, hh, yy)
        return jnp.sum(out * jnp.arange(out.size).reshape(out.shape) / 50.0
                       ), out

    (_, out_j), grads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(
        params, jnp.asarray(h), jnp.asarray(y))
    t = tlayers.GRUUpdate(8)
    t.load_state_dict(from_jax(params))
    ht = torch.from_numpy(h).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    out = t(ht, yt)
    assert out.shape == (3, 4, 8)
    torch.sum(out * torch.arange(out.numel()).reshape(out.shape) / 50.0
              ).backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **tol)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(grads[1]), **tol)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(grads[2]), **tol)
    # flax has no r and z hidden biases: from_jax gives zeros for them, and
    # the port masks their gradient, so they stay 0 under training
    want = from_jax(_np(grads[0]))
    for k, p in t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   err_msg=k, **tol)
    assert not bool(t.cell.bias_hh.grad[:16].any())
    assert not bool(tlayers.GRUUpdate(8).cell.bias_hh[:16].any())


def test_dropout_generator_mask():
    """Eval mode and p = 0 are the identity; one seed gives one mask; the
    kept share is 1 - p within 1% on 200,000 draws and kept entries are
    scaled by 1/(1-p)."""
    x = torch.ones(200, 1000)
    d = tlayers.Dropout(0.3, torch.Generator().manual_seed(5))
    d.eval()
    assert d(x) is x
    assert tlayers.Dropout(0.0, None).train()(x) is x
    d.train()
    a = d(x)
    d.generator.manual_seed(5)
    b = d(x)
    assert torch.equal(a, b)
    assert not torch.equal(a, d(x))            # the stream moves on
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    np.testing.assert_allclose(a[kept].numpy(), 1 / 0.7, rtol=1e-6)
    with pytest.raises(ValueError):
        tlayers.Dropout(1.0)
