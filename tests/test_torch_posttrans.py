"""The PNA layer's scaled posttrans (``pna_tpu_torch/ops/posttrans.py``) on
the CPU.

* The layer's update phase calls ``posttrans.scaled_posttrans``; on the CPU
  that is the plain version, which must give the numbers of the formula the
  layer computed inline before (copied here as ``_inline``) bit for bit: the
  layer's output, the gradients of its input and of every parameter, and
  the batch-norm statistics, on the ``csr``, ``csr_fused`` and overlap
  paths, with per-tower and shared inputs, in float32 and bfloat16.
* A float64 ``gradcheck`` of the entry ``scaled_posttrans`` on the CPU (the
  plain version), for both forms of h; ``ScaledPosttrans``, the function
  over the kernels, raises where ``w`` would take a gradient; the shapes
  are checked.
* No kernel launches on the CPU: the launch counts stay 0.

The kernels themselves are held to the plain version and its autograd
gradients by
tests/test_torch_csrc_host.py (their source compiled for the host) and by
tests/test_torch_cuda.py on the card."""

import numpy as np
import pytest
import torch

from pna_tpu_torch.graph import batch_graphs
from pna_tpu_torch.nn import fused
from pna_tpu_torch.nn.fused import PNALayerFused
from pna_tpu_torch.ops import posttrans as pt
from pna_tpu_torch.ops.posttrans import round_to, shared_ein, tower_ein

AGGS = ('mean', 'max', 'min', 'std')
SCALERS = ('identity', 'amplification', 'attenuation')
AVG_D = {'lin': 3.1, 'log': 1.2}
D, T = 12, 3


def _inline(z, h, w, kp, bp, *, shared=False, cdt=torch.float32):
    """The update phase's posttrans layer 0 as the layer wrote it inline
    before ``ops/posttrans.py``."""
    N, A, TF = z.shape
    Tl, _, Fo = kp.shape
    Ft, S = TF // Tl, w.shape[0]
    k_h = kp[:, :Ft]
    k_agg = kp[:, Ft:].reshape(Tl, S, A, Ft, Fo)
    if not shared:
        out = tower_ein(h.reshape(N, Tl, Ft), k_h, cdt)
    else:
        out = shared_ein(h, k_h, cdt)
    eye = torch.eye(Tl, dtype=kp.dtype, device=kp.device)
    W = round_to(torch.einsum(
        'tsafo,tu->atfuos', k_agg, eye).reshape(
            A * Tl * Ft, Tl * Fo * S), cdt)
    y = (round_to(z.reshape(N, A * Tl * Ft), cdt) @ W).reshape(
        N, Tl, Fo, S)
    return out + torch.einsum('ntos,sn->nto', round_to(y, cdt),
                              round_to(w, cdt)) + bp


def _graph(rng):
    graphs = []
    for _ in range(5):
        n = rng.randint(5, 12)
        adj = (rng.rand(n, n) < 0.4) & ~np.eye(n, dtype=bool)
        s, r = np.nonzero(adj)
        graphs.append(dict(node_feats=rng.randn(n, 2).astype(np.float32),
                           senders=s.astype(np.int32),
                           receivers=r.astype(np.int32)))
    return batch_graphs(graphs, with_snorm=True)


def _overlap(g, rng):
    """The split-edge tuple of the overlap path on one batch: the real edges
    whose sender is even are local, the others come from a halo of 7 rows."""
    n_halo = 7
    snd, rcv = g.senders.numpy(), g.receivers.numpy()
    real = g.edge_mask.numpy()
    loc = real & (snd % 2 == 0)
    bnd = real & (snd % 2 == 1)
    halo = torch.from_numpy(rng.randn(n_halo, D).astype(np.float32))

    def part(sel, senders):
        return (torch.from_numpy(senders[sel]).long(),
                torch.from_numpy(rcv[sel]).long(),
                torch.ones(int(sel.sum()), dtype=torch.bool))

    s_l, r_l, m_l = part(loc, snd)
    s_b, r_b, m_b = part(bnd, snd % n_halo)
    return (halo.requires_grad_(), s_l, r_l, m_l, s_b, r_b, m_b)


def _run(path, divide_input, cdt):
    """(output, input gradient, every parameter gradient, batch-norm
    statistics) of one training-mode forward and backward of sum(out^2)."""
    rng = np.random.RandomState(3)
    g = _graph(rng)
    h = torch.from_numpy(rng.randn(g.n_node_pad, D).astype(np.float32))
    h.requires_grad_()
    kernel = 'csr' if path == 'overlap' else path
    layer = PNALayerFused(D, D, AGGS, SCALERS, AVG_D, towers=T,
                          divide_input=divide_input, graph_norm=True,
                          batch_norm=True, residual=True, kernel=kernel,
                          compute_dtype=cdt, device='cpu',
                          generator=torch.Generator().manual_seed(5))
    layer.train()
    overlap = _overlap(g, rng) if path == 'overlap' else None
    out = layer(g, h, overlap=overlap)
    (out ** 2).sum().backward()
    grads = [h.grad] + [p.grad for p in layer.parameters()]
    stats = [b.clone() for b in layer.buffers()]
    return out.detach(), grads, stats


@pytest.mark.parametrize('cdt', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('divide_input', [True, False])
@pytest.mark.parametrize('path', ['csr', 'csr_fused', 'overlap'])
def test_plain_posttrans_is_the_inline_formula(monkeypatch, path,
                                               divide_input, cdt):
    """Bit for bit: the layer through ``scaled_posttrans`` and through the
    inline formula it replaced."""
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return pt.scaled_posttrans(*args, **kw)

    monkeypatch.setattr(fused, 'scaled_posttrans', counted)
    got = _run(path, divide_input, cdt)
    assert calls == [1]
    monkeypatch.setattr(fused, 'scaled_posttrans', _inline)
    want = _run(path, divide_input, cdt)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert (a is None and b is None) or torch.equal(a, b)


def _inputs(shared, n=9, towers=2, ft=3, fo=4, a=4, s=3, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    z = rnd(n, a, towers * ft).requires_grad_()
    h = rnd(n, ft if shared else towers * ft).requires_grad_()
    kp = rnd(towers, (a * s + 1) * ft, fo).requires_grad_()
    bp = rnd(towers, fo).requires_grad_()
    w = rnd(s, n).abs() + 0.5
    return z, h, kp, bp, w


@pytest.mark.parametrize('shared', [False, True])
def test_scaled_posttrans_function_gradcheck(shared):
    """The entry's gradients on the CPU (the plain version through
    autograd) are the derivative of its forward, in float64, and its forward
    is the plain version's."""
    z, h, kp, bp, w = _inputs(shared)

    def f(z, h, kp, bp):
        return pt.scaled_posttrans(z, h, w, kp, bp, shared=shared)

    assert torch.autograd.gradcheck(f, (z, h, kp, bp))
    assert torch.equal(f(z, h, kp, bp),
                       pt.scaled_posttrans_plain(z, h, w, kp, bp, shared))


@pytest.mark.parametrize('bad', ['kp_rows', 'w_nodes'])
def test_scaled_posttrans_refuses_shapes_that_disagree(bad):
    """kp's rows must be (A S + 1) Ft and w must hold a weight a node."""
    z, h, kp, bp, w = _inputs(False)
    if bad == 'kp_rows':
        kp = kp[:, 1:]
    else:
        w = w[:, 1:]
    with pytest.raises(ValueError, match='do not agree'):
        pt.scaled_posttrans(z, h, w, kp, bp)


def test_scaled_posttrans_refuses_a_gradient_of_w():
    z, h, kp, bp, w = _inputs(False)
    with pytest.raises(ValueError, match='w takes no gradient'):
        pt.ScaledPosttrans.apply(z, h, kp, bp, w.requires_grad_(), False,
                                 torch.float32)


def test_no_posttrans_launch_on_the_cpu():
    pt.reset_launch_counts()
    _run('csr', True, torch.float32)
    assert pt.launch_counts() == {'scaled_posttrans_fwd': 0,
                                  'scaled_posttrans_bwd': 0}


def test_roofline_reader_takes_each_launch_at_its_bound():
    """The benchmark's ``posttrans_roofline`` reader at the large-graph
    cell's net: forward 0.97 GB (0.2896 ms at 3.35 TB/s) against 16.6 GFLOP
    (0.2483 ms at 67 TFLOP/s), backward 1.77 GB (0.5284 ms) against 33.3
    GFLOP (0.4967 ms); the merge's time counts; nothing to read without the
    kernels, a trace, a shape or a net."""
    from portbench import spec
    from portbench.peaks import PEAKS
    from portbench.reference.pna import net_of
    from portbench.trace import Trace
    metric = spec.load_metric('posttrans_roofline')
    cfg = spec.load_cell('largegraph_pna.powerlaw_6m').config
    n = 625_000
    peak = PEAKS['NVIDIA H100 80GB HBM3']
    fwd_s = 4 * n * (256 + 64 + 3 + 64) / 3.35e12
    bwd_s = 4 * n * (2 * 256 + 2 * 64 + 3 + 64) / 3.35e12
    assert fwd_s > 2 * n * 4 * (12 * 256 + 256) / 67e12

    def ctx(kernels, shape=True, net=True):
        trace = Trace.__new__(Trace)
        trace.kernels = kernels
        driver = type('Driver', (), {})()
        if shape:
            driver.aggregation_shape = lambda: dict(rows=6_250_000, nodes=n,
                                                    f=64)
        if net:
            driver.net = net_of(cfg)
        return type('Ctx', (), dict(trace=trace, peak=peak,
                                    driver=driver))()

    shape = '(anonymous namespace)::Shape<16, 16, 4, 3>'
    kernels = {
        f'void (anonymous namespace)::scaled_posttrans_fwd_kernel<{shape}>'
        '((anonymous namespace)::Args)': (20, 20 * 2 * fwd_s),
        f'void (anonymous namespace)::scaled_posttrans_bwd_kernel<{shape}>'
        '((anonymous namespace)::Args)': (20, 20 * 3 * bwd_s),
        f'void (anonymous namespace)::scaled_posttrans_merge_kernel<{shape}>'
        '((anonymous namespace)::Args)': (20, 20 * bwd_s),
        'csr_dmsg_kernel<true>': (20, 1.0)}
    assert metric.read(ctx(kernels)) == pytest.approx(
        100 * (fwd_s + bwd_s) / (2 * fwd_s + 4 * bwd_s))
    assert metric.read(ctx({'csr_dmsg_kernel<true>': (20, 1.0)})) is None
    assert metric.read(ctx(kernels, shape=False)) is None
    assert metric.read(ctx(kernels, net=False)) is None
