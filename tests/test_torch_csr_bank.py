"""The CSR bank (pna_tpu_torch.ops.csr_bank) against the Pallas bank
(pna_tpu.ops.pallas_bank.make_pallas_raw_bank, interpret mode): forward and
message gradient, with the JAX backward both on its kernel and on its gather
form; pad edges, the max_degree hint, and K2's plain version against the
gather form.  Tolerances: Z rtol 1e-5, atol 1e-5; d_msg rtol 1e-4, atol
1e-5, as tests/test_pallas_bank.py holds the JAX banks to each other."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu.graph import batch_graphs as j_batch_graphs
from pna_tpu.ops.pallas_bank import make_pallas_raw_bank
from pna_tpu_torch.graph import batch_graphs
from pna_tpu_torch.ops import csr_bank
from pna_tpu_torch.ops.csr_kernels import csr_dmsg_plain, csr_moment_sketch

AGGS = ('mean', 'max', 'min', 'std')


def _random_graphs(rng, n_graphs=6, lo=5, hi=12):
    graphs = []
    for _ in range(n_graphs):
        n = rng.randint(lo, hi)
        adj = (rng.rand(n, n) < 0.4) & ~np.eye(n, dtype=bool)
        s, r = np.nonzero(adj)
        graphs.append(dict(node_feats=rng.randn(n, 8).astype(np.float32),
                           senders=s.astype(np.int32),
                           receivers=r.astype(np.int32)))
    return graphs


def _batch(seed, **kw):
    rng = np.random.RandomState(seed)
    graphs = _random_graphs(rng)
    tg = batch_graphs(graphs, **kw)
    jg = j_batch_graphs(graphs, with_ell=False, sort_edges=True, **kw)
    return rng, tg, jg


def _torch_grad(msg, layout, aggs):
    m = torch.from_numpy(msg).requires_grad_(True)
    z = csr_bank.csr_raw_bank(m, layout, aggs)
    torch.sum(torch.sin(z * 0.7)).backward()
    return z.detach().numpy(), m.grad.numpy()


@pytest.mark.parametrize("bwd_kernel", [True, False])
@pytest.mark.parametrize("aggs", [AGGS, ('sum', 'var', 'mean')])
def test_bank_matches_pallas_bank(aggs, bwd_kernel):
    rng, tg, jg = _batch(0, n_edge_pad=512)
    E = tg.n_edge_pad
    msg = rng.randn(E, 16).astype(np.float32)
    msg[1] = msg[0]                           # tie material
    msg[~tg.edge_mask.numpy()] = 1e6          # pad rows carry garbage

    bank = make_pallas_raw_bank(jg.receivers, jg.edge_mask, jg.edge_ptr,
                                interpret=True, bwd_kernel=bwd_kernel)
    zj = np.asarray(bank(jnp.asarray(msg), aggs))
    gj = np.asarray(jax.grad(lambda m: jnp.sum(jnp.sin(bank(m, aggs) * 0.7)))(
        jnp.asarray(msg)))

    zt, gt = _torch_grad(msg, csr_bank.layout_from_graph(tg), aggs)
    np.testing.assert_allclose(zt, zj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5)
    pad = ~tg.edge_mask.numpy()
    assert pad.sum() > 100 and np.all(gt[pad] == 0.0)


@pytest.mark.parametrize("bwd_kernel", [True, False])
def test_bank_with_a_split_node_matches_pallas_bank(bwd_kernel):
    """A star of 40 leaves among ordinary graphs: its centre has more than
    SEG in-edges, so the layout's table splits it and the bank hands that
    table to K1 and K2.  Pad messages are non-zero and one pad row holds a
    NaN: neither enters Z, and the pad rows of d_msg are exactly 0 with no
    mask after K2."""
    rng = np.random.RandomState(5)
    leaves = np.arange(1, 41, dtype=np.int32)
    star = dict(node_feats=rng.randn(41, 8).astype(np.float32),
                senders=np.concatenate([leaves, [0]]).astype(np.int32),
                receivers=np.concatenate([np.zeros(40, np.int32), [3]]))
    graphs = _random_graphs(rng, 3) + [star] + _random_graphs(rng, 2)
    tg = batch_graphs(graphs, n_edge_pad=512)
    jg = j_batch_graphs(graphs, with_ell=False, sort_edges=True,
                        n_edge_pad=512)
    layout = csr_bank.layout_from_graph(tg)
    assert tg.max_in_degree == 40 and layout.segments.n_split == 1
    assert layout.segments.n_part == 2
    pad = ~tg.edge_mask.numpy()
    msg = rng.randn(tg.n_edge_pad, 16).astype(np.float32)
    msg[1] = msg[0]                           # tie material
    msg[pad] = 1e6
    msg_nan = msg.copy()
    msg_nan[np.nonzero(pad)[0][3], 5] = np.nan

    bank = make_pallas_raw_bank(jg.receivers, jg.edge_mask, jg.edge_ptr,
                                interpret=True, bwd_kernel=bwd_kernel)
    zj = np.asarray(bank(jnp.asarray(msg), AGGS))
    gj = np.asarray(jax.grad(lambda m: jnp.sum(jnp.sin(bank(m, AGGS) * 0.7)))(
        jnp.asarray(msg)))

    zt, gt = _torch_grad(msg_nan, layout, AGGS)
    np.testing.assert_allclose(zt, zj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt[~pad], gj[~pad], rtol=1e-4, atol=1e-5)
    assert pad.sum() > 100 and np.all(gt[pad] == 0.0)


def test_backward_does_not_mask():
    """K2 writes the pad rows itself, so the bank's backward is K2's output
    as it comes: no ``where`` over [E, F] follows."""
    import ast
    import inspect
    import textwrap
    tree = ast.parse(textwrap.dedent(
        inspect.getsource(csr_bank.CSRBank.backward)))
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert "where" not in called and "masked_fill" not in called


def test_forward_without_grad_matches():
    """Without autograd the bank runs K1 without tie counts; same Z."""
    rng, tg, _ = _batch(1)
    msg = torch.from_numpy(rng.randn(tg.n_edge_pad, 6).astype(np.float32))
    layout = csr_bank.layout_from_graph(tg)
    with torch.no_grad():
        z0 = csr_bank.csr_raw_bank(msg.requires_grad_(True), layout, AGGS)
    z1 = csr_bank.csr_raw_bank(msg, layout, AGGS)
    assert z1.requires_grad and not z0.requires_grad
    torch.testing.assert_close(z0, z1.detach(), rtol=0, atol=0)


def test_bad_max_degree_hint_raises():
    _, tg, _ = _batch(3)
    true_max = tg.max_in_degree
    assert true_max > 1
    with pytest.raises(ValueError, match="under-reduce"):
        csr_bank.layout_from_graph(tg, max_degree=1)
    with pytest.raises(ValueError, match="under-reduce"):   # read from ptr
        csr_bank.csr_layout(tg.edge_ptr, tg.edge_mask, max_degree=1)
    csr_bank.layout_from_graph(tg, max_degree=true_max)
    with pytest.raises(ValueError, match="aggregators"):
        csr_bank.csr_raw_bank(torch.zeros(tg.n_edge_pad, 2),
                              csr_bank.layout_from_graph(tg), ('identity',))


def test_plain_dmsg_is_the_gather_form():
    """K2's plain version is the JAX bank's gather backward
    (pallas_bank.py, bwd_kernel=False): the six node fields gathered through
    the receivers, bit for bit."""
    rng, tg, _ = _batch(4)
    layout = csr_bank.layout_from_graph(tg)
    E, N, F = tg.n_edge_pad, tg.n_node_pad, 9
    msg = torch.from_numpy(rng.randn(E, F).astype(np.float32))
    s, sq, mx, mn, tmx, tmn = csr_moment_sketch(msg, layout.ptr, True)
    g_lin, g_quad, g_max, g_min = (
        torch.from_numpy(rng.randn(N, F).astype(np.float32))
        for _ in range(4))
    got = csr_dmsg_plain(msg, layout.ptr, g_lin, g_quad, g_max, g_min, mx, mn)

    r = tg.receivers.numpy()
    m = msg.numpy()
    fe = np.concatenate([x.numpy() for x in
                         (g_lin, g_quad, g_max, g_min, mx, mn)], -1)[r]
    want = (fe[:, :F] + 2.0 * m * fe[:, F:2 * F]
            + (m == fe[:, 4 * F:5 * F]).astype(np.float32) * fe[:, 2 * F:3 * F]
            + (m == fe[:, 5 * F:]).astype(np.float32) * fe[:, 3 * F:4 * F])
    em = tg.edge_mask.numpy()
    np.testing.assert_array_equal(got.numpy()[em], want[em])
    assert np.all(got.numpy()[~em] == 0)
