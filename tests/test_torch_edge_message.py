"""The ``csr`` backend's messages built from node halves, on the CPU.

``csr_bank.csr_messages`` builds the first pretrans layer's messages
``u[senders] + v[receiver] (+ w)`` from the node halves ``u = h K_src`` and
``v = h K_dst + b0`` (the kernel ``csr_kernels.csr_edge_message``; on the
CPU its plain version).  Held here:

* the plain version against ``csr_fused_kernels.pretrans_messages_plain``,
  the messages K3/K4 form, on the layout cases of the card tests (rows
  outside every range take the same rows of ``v``), bit for bit;
* its gradients against autograd through the gathers it replaces
  (``index_select`` of a ghost sender table and of ``v``, the pad rows'
  gradient dropped as K2 drops it);
* the ``csr`` layer against the same layer with the old edge form put back
  in the test (``pretrans_edges`` on gathered rows: each gathered half
  multiplied by its kernel over edges, then ``e K_e`` and ``b0``): output,
  every parameter gradient and the input gradients, with and without edge
  features, ``divide_input`` both ways, one and two pretrans layers,
  float32 within float32 round-off (rtol 1e-5, atol 1e-6: the node halves
  are the same products over other rows, summed in other orders) and
  bfloat16 within 5e-2 of each gradient's norm (the bound of the port's
  other bfloat16 tests: a float32 difference in the last place moves a
  value across a bfloat16 rounding boundary now and then);
* the message build is called once per layer on ``csr`` and never on the
  other backends.
"""

import numpy as np
import pytest
import torch

from pna_tpu_torch.graph import batch_graphs
from pna_tpu_torch.nn.fused import PNALayerFused
from pna_tpu_torch.ops.posttrans import shared_ein, tower_ein
from pna_tpu_torch.ops import csr_bank
from pna_tpu_torch.ops import csr_fused_kernels as fk
from pna_tpu_torch.ops import csr_kernels as ck
from pna_tpu_torch.ops.segment import gather_rows
from tests.test_torch_cuda import (CASES, GHOST, layout_case,
                                   pretrans_inputs, valid_rows)

AGGS = ('mean', 'max', 'min', 'std')
SCALERS = ('identity', 'amplification', 'attenuation')
AVG_D = {'lin': 3.1, 'log': 1.2}
D, FE, T = 12, 5, 3


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_w", [False, True])
def test_plain_messages_match_numpy(case, with_w):
    """On the layout cases of the card tests, shifted 2 rows down so that
    rows before ptr[0] belong to no node: (u[snd] + v[node]) + w in numpy,
    a row's node found by its range, 0 before ptr[0] and N - 1 from ptr[N]
    on; the fused kernels' plain messages are the same without w."""
    msg, ptr = layout_case(case)
    e = len(msg)
    u, v, snd, _, _ = pretrans_inputs(ptr, e, 12, 3, ghost=True)
    ptr = np.minimum(ptr + 2, e).astype(np.int32)
    w = np.random.RandomState(4).randn(e, 12).astype(np.float32)
    rows = np.arange(e)
    node = np.clip(np.searchsorted(ptr, rows, side='right') - 1, 0,
                   len(ptr) - 2)
    node[rows >= ptr[-1]] = len(ptr) - 2
    want = u[snd] + v[node]
    if with_w:
        want = want + w
    args = [torch.from_numpy(x) for x in (u, v, snd, ptr)]
    got = ck.csr_edge_message(*args, torch.from_numpy(w) if with_w else None)
    assert np.array_equal(got.numpy(), want)
    if not with_w:
        assert torch.equal(fk.pretrans_messages_plain(*args), got)


def _layout(ptr, snd, e):
    ptr, snd = torch.from_numpy(ptr), torch.from_numpy(snd)
    mask = torch.from_numpy(valid_rows(ptr.numpy(), e))
    return csr_bank.csr_layout(ptr, mask, senders=snd.long()), snd, ptr


@pytest.mark.parametrize("case", CASES)
def test_message_grads_are_the_gathers_grads(case):
    """d_u, d_v and d_w of the message build against autograd through
    ``u[senders] + v[receiver] + w``, a ghost sender table, the pad rows'
    gradient zero (as K2 writes it).  The sums add in another order (d_v
    in the row sum's, the gathers' in index order): within 1e-6 of the
    magnitudes they add (the hub's node adds 1,200 rows)."""
    msg, ptr = layout_case(case)
    e = len(msg)
    u, v, snd, _, _ = (torch.from_numpy(x) for x in pretrans_inputs(
        ptr, e, 12, 5, ghost=True))
    layout, snd, ptr_t = _layout(ptr, snd.numpy(), e)
    valid = torch.from_numpy(valid_rows(ptr, e))
    g = torch.randn(e, 12) * valid[:, None]
    w = torch.randn(e, 12)
    rcv, _ = ck._row_segments(ptr_t, e)
    grads = []
    for build, dm in (('kernel', g), ('gathers', g), ('gathers', g.abs())):
        x = [t.clone().requires_grad_(True) for t in (u, v, w)]
        if build == 'kernel':
            m = csr_bank.csr_messages(*x, layout)
        else:
            m = x[0][snd.long()] + x[1][rcv] + x[2]
        torch.sum(m * dm).backward()
        grads.append([t.grad for t in x])
    assert u.shape[0] == v.shape[0] + GHOST
    for got, want, scale in zip(*grads):
        assert torch.all((got - want).abs() <= 1e-6 * scale + 1e-6)
    assert torch.equal(grads[0][2], g)


def test_messages_without_senders_raise():
    ptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    layout = csr_bank.csr_layout(ptr, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="senders"):
        csr_bank.csr_messages(torch.zeros(2, 4), torch.zeros(2, 4), None,
                              layout)


def _graph_and_inputs(seed=1):
    rng = np.random.RandomState(seed)
    graphs = []
    for _ in range(6):
        n = rng.randint(5, 12)
        adj = (rng.rand(n, n) < 0.4) & ~np.eye(n, dtype=bool)
        s, r = np.nonzero(adj)
        graphs.append(dict(node_feats=rng.randn(n, 2).astype(np.float32),
                           senders=s.astype(np.int32),
                           receivers=r.astype(np.int32)))
    g = batch_graphs(graphs, with_snorm=True)
    h = rng.randn(g.n_node_pad, D).astype(np.float32)
    h[0] = h[1]                          # equal messages: max/min ties
    e = rng.randn(g.n_edge_pad, FE).astype(np.float32)
    return g, torch.from_numpy(h), torch.from_numpy(e)


def _edge_form(layer, graph, h, e):
    """The ``csr`` messages before the later pretrans layers as the layer
    built them by edge: the sender and receiver rows gathered, each
    multiplied by its half of the first kernel over the edges, ``e K_e``
    added, then ``b0``."""
    cdt, Tl, Ft = layer.compute_dtype, layer.local_towers, layer.ft
    hb = h.to(cdt)
    k0, b0 = layer.pretrans.layer(0)
    k_src, k_dst = k0[:, :Ft], k0[:, Ft:2 * Ft]
    src = gather_rows(hb, graph.senders)
    dst = gather_rows(hb, graph.receivers, graph.edge_ptr)
    E = src.shape[0]
    if layer.divide_input:
        msg = (tower_ein(src.reshape(E, Tl, Ft), k_src, cdt)
               + tower_ein(dst.reshape(E, Tl, Ft), k_dst, cdt))
    else:
        msg = (shared_ein(src, k_src, cdt)
               + shared_ein(dst, k_dst, cdt))
    if layer.edge_features:
        msg = msg + shared_ein(e, k0[:, 2 * Ft:], cdt)
    return (msg + b0).reshape(E, Tl * Ft)


def _step(monkeypatch, edge_form, graph, h0, e0, **kw):
    layer = PNALayerFused(D, D, AGGS, SCALERS, AVG_D, towers=T,
                          graph_norm=True, batch_norm=True, residual=True,
                          edge_dim=FE, kernel='csr', device='cpu',
                          generator=torch.Generator().manual_seed(3), **kw)
    layer.train()
    h = h0.clone().requires_grad_(True)
    e = e0.clone().requires_grad_(True)
    with monkeypatch.context() as m:
        if edge_form:
            m.setattr(csr_bank, 'csr_messages',
                      lambda u, v, w, layout: _edge_form(layer, graph, h, e))
        out = layer(graph, h, e if kw.get('edge_features') else None)
    torch.sum(torch.sin(out)).backward()
    grads = {k: p.grad for k, p in layer.named_parameters()}
    grads['h'] = h.grad
    if kw.get('edge_features'):
        grads['e'] = e.grad
    return out.detach(), grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pretrans_layers", [1, 2])
@pytest.mark.parametrize("divide_input", [True, False])
@pytest.mark.parametrize("edge_features", [True, False])
def test_csr_layer_matches_the_edge_form(monkeypatch, edge_features,
                                         divide_input, pretrans_layers,
                                         dtype):
    graph, h, e = _graph_and_inputs()
    kw = dict(edge_features=edge_features, divide_input=divide_input,
              pretrans_layers=pretrans_layers, compute_dtype=dtype)
    out, grads = _step(monkeypatch, False, graph, h, e, **kw)
    out_e, grads_e = _step(monkeypatch, True, graph, h, e, **kw)
    assert set(grads) == set(grads_e)
    if dtype == torch.float32:
        torch.testing.assert_close(out, out_e, rtol=1e-5, atol=1e-6)
        for k in grads:
            torch.testing.assert_close(grads[k], grads_e[k], rtol=1e-5,
                                       atol=1e-6, msg=k)
        return
    torch.testing.assert_close(out, out_e, rtol=1e-2, atol=1e-2)
    for k in grads:
        err = torch.linalg.norm(grads[k] - grads_e[k])
        assert err <= 5e-2 * torch.linalg.norm(grads_e[k]) + 1e-6, k


@pytest.mark.parametrize("kernel,calls", [
    ('csr', 1), ('csr_fused', 0), ('generic', 0)])
def test_message_build_runs_on_csr_alone(monkeypatch, kernel, calls):
    rng = np.random.RandomState(4)
    graphs = [dict(node_feats=rng.randn(n, 2).astype(np.float32),
                   senders=rng.randint(0, n, 2 * n).astype(np.int32),
                   receivers=rng.randint(0, n, 2 * n).astype(np.int32))
              for n in (5, 9, 7)]
    graph = batch_graphs(graphs)
    seen = []
    real = csr_bank.csr_messages

    def counted(*args):
        seen.append(1)
        return real(*args)

    monkeypatch.setattr(csr_bank, 'csr_messages', counted)
    layer = PNALayerFused(D, D, AGGS, SCALERS, AVG_D,
                          towers=T, kernel=kernel, device='cpu')
    h = torch.randn(graph.n_node_pad, D, requires_grad=True)
    torch.sum(layer(graph, h)).backward()
    assert len(seen) == calls
    assert h.grad is not None


def test_roofline_reader_counts_each_byte_once():
    """The benchmark's ``edge_message_roofline`` reader: the bound of each
    launch at the cell's shape over the kernel's device time; nothing to
    read without the kernel, a trace or a shape."""
    from portbench import spec
    from portbench.peaks import PEAKS
    from portbench.trace import Trace
    metric = spec.load_metric('edge_message_roofline')
    rows, nodes, f = 6_250_000, 625_000, 64
    peak = PEAKS['NVIDIA H100 80GB HBM3']
    want_s = (4 * rows * f + 2 * 4 * nodes * f + 8 * rows) / 3.35e12

    def ctx(kernels, shape=True):
        trace = Trace.__new__(Trace)
        trace.kernels = kernels
        driver = type('Driver', (), {})()
        if shape:
            driver.aggregation_shape = lambda: dict(rows=rows, nodes=nodes,
                                                    f=f)
        return type('Ctx', (), dict(trace=trace, peak=peak,
                                    driver=driver))()

    name = ('void (anonymous namespace)::csr_edge_message_kernel<4, '
            'false>(EdgeMessageArgs)')
    got = metric.read(ctx({name: (20, 20 * 2 * want_s),
                           'csr_dmsg_kernel<true>': (20, 1.0)}))
    assert got == pytest.approx(50.0)
    assert metric.read(ctx({'csr_dmsg_kernel<true>': (20, 1.0)})) is None
    assert metric.read(ctx({name: (20, 1.0)}, shape=False)) is None
