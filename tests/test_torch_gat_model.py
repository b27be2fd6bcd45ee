"""GAT on the large-graph trainer, on the CPU: ``nn/gat.py::GATLayerCSR``,
``parallel/distributed_net.py::DistributedGATNet`` and the trainer's
``model='gat'`` path against the plain reference
(``pna_tpu_torch/reference/gat.py``), on seeded weights at a small size: a
power-law sender table with a hub of ~40% of the edges, a node with no
in-edges, heads 4 x 8, 4 x 8 with the skip connection, 6 x 5 averaged, 50
input features.

Tolerances: the port and the reference sum in different orders (the
attention's sums by receiver and by sender against ``index_add``, the
scores as one product against a sum), so values agree to float32 round-off
of sums of a few hundred terms: forward and loss rtol 1e-5, gradients rtol
1e-4 with atol 1e-5 of the gradient's largest magnitude (a gradient's sums
cancel; the hub's rows are sums of ~240 terms).  Adam's first step moves
each element by lr g / (|g| + eps), about lr sign(g): the step taken is
held to that of the program's own gradient within 1e-4 of lr (the
optimiser's round-off), and to the reference's step within 1e-3 of lr
wherever the reference gradient is over 1e-4 of its largest magnitude (an
element whose gradient is round-off itself may step either way, by the
thread count of the CPU's sums).  A wrong edge, head, bias or skip term
moves these by 1e-2 or more."""

import numpy as np
import pytest
import torch

from pna_tpu_torch.nn.gat import GATLayerCSR
from pna_tpu_torch.parallel.distributed_net import (DistributedGATNet,
                                                    DistributedPNANet,
                                                    part_tables)
from pna_tpu_torch.parallel.partition import (partition_edges,
                                              sort_partition_edges)
from pna_tpu_torch.reference import gat as ref
from pna_tpu_torch.train import largegraph as lg
from tests import _torch_dist_ranks as ranks

HEADS, HEAD_DIM, FEAT, LABELS = (4, 4, 6), (8, 8, 5), 50, 5
NET = dict(heads=HEADS, head_dim=HEAD_DIM, residual_layers=(1,),
           feat_dim=FEAT, label_dim=LABELS)


def graph_case(n=60, e=600, seed=0):
    """Power-law senders with one of ~40% of the edges, uniform receivers,
    node 3 with no in-edges."""
    rng = np.random.RandomState(seed)
    w = np.arange(1, n + 1, dtype=np.float64) ** -1.5
    send = rng.permutation(n)[rng.choice(n, size=e, p=w / w.sum())]
    send[rng.rand(e) < 0.4] = 11
    recv = rng.randint(0, n, e)
    recv[recv == 3] = 4
    return send.astype(np.int64), recv.astype(np.int64)


class Problem:
    """One part of the graph in the csr layout, its features, labels and
    training mask, the reference's graph over the part's local ids."""

    def __init__(self, net, n=60, e=600, seed=0):
        send, recv = graph_case(n, e, seed)
        part = sort_partition_edges(partition_edges(send, recv, n, 1))
        self.part = part
        self.tables = part_tables(part, net, 0, 'cpu')
        g = self.tables.graph
        m = g.edge_mask
        self.ref_graph = ref.graph_of(g.senders[m], g.receivers[m],
                                      part.nodes_per_part)
        rng = np.random.RandomState(seed + 1)
        feats = rng.randn(n, FEAT).astype(np.float32)
        labels = (rng.rand(n, LABELS) < 0.5).astype(np.float32)
        train = rng.rand(n) > 0.2
        self.x = torch.from_numpy(part.scatter_features(feats)[0])
        self.y = torch.from_numpy(part.scatter_features(labels)[0])
        tm = part.scatter_features(train[:, None].astype(np.float32))[0, :, 0]
        self.mask = torch.from_numpy(part.node_mask[0] & (tm > 0))
        self.train = torch.nonzero(self.mask).squeeze(1)
        self.n_edges = int(m.sum())


def _net(seed=0):
    return DistributedGATNet(FEAT, heads=HEADS, head_dim=HEAD_DIM,
                             residual_layers=(1,), device='cpu', seed=seed)


def _weights(module, prefix=''):
    return {prefix + k: v.detach().clone()
            for k, v in module.state_dict().items()}


def _close(got, want, rtol=1e-4, atol=1e-5):
    torch.testing.assert_close(
        got, want, rtol=rtol,
        atol=atol * max(1.0, float(want.detach().abs().max())))


@pytest.mark.parametrize("concat,residual,elu", [(True, False, True),
                                                 (True, True, True),
                                                 (False, False, False)])
def test_layer_is_the_reference_layer(concat, residual, elu):
    net = _net()
    prob = Problem(net)
    gen = torch.Generator().manual_seed(5)
    heads, f = (4, 8) if concat else (6, 5)
    layer = GATLayerCSR(FEAT, heads, f, concat=concat, residual=residual,
                        elu=elu, device='cpu', generator=gen)
    with torch.no_grad():      # biases away from 0, so that they count
        layer.bias.uniform_(-0.1, 0.1, generator=gen)
        if residual:
            layer.skip.bias.uniform_(-0.1, 0.1, generator=gen)
    x = prob.x.clone().requires_grad_(True)
    out = layer(x, prob.tables.layout)
    P = {k: v.requires_grad_(True)
         for k, v in _weights(layer, 'layers.0.').items()}
    xr = prob.x.clone().requires_grad_(True)
    want = ref.layer(P, 0, dict(heads=heads, f=f, concat=concat,
                                residual=residual, elu=elu), xr,
                     prob.ref_graph, False)
    _close(out, want, rtol=1e-5, atol=1e-6)
    go = torch.randn(out.shape, generator=gen)
    names = [n for n, _ in layer.named_parameters()]
    got = torch.autograd.grad((out * go).sum(),
                              [x] + [p for _, p in layer.named_parameters()])
    wg = torch.autograd.grad((want * go).sum(),
                             [xr] + [P['layers.0.' + n] for n in names])
    for a, b in zip(got, wg):
        _close(a, b)


def test_net_step_is_the_reference_step():
    """The trainer's step (``make_node_train_step``, one process, no mesh;
    the GAT net's loss is 'bce'): the forward's logits, the loss, every
    gradient and Adam's first step against the reference's."""
    net = _net(seed=3)
    for layer in net.layers:            # biases away from 0
        with torch.no_grad():
            layer.bias.uniform_(-0.1, 0.1)
    prob = Problem(net)
    w0 = _weights(net)
    lr = 0.005
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    step, _, _ = lg.make_node_train_step(prob.part, None, net, opt)
    with torch.no_grad():
        logits = net(prob.tables.graph, prob.x,
                     **prob.tables.net_kwargs(distributed=False))
    loss = step(prob.x, prob.y, prob.mask)

    P = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    net_cfg = dict(NET)
    _close(logits, ref.forward(P, net_cfg, prob.ref_graph, prob.x),
           rtol=1e-5, atol=1e-6)
    want = ref.node_loss(P, net_cfg, prob.ref_graph, prob.x, prob.y,
                         prob.train)
    assert abs(loss - want.item()) <= 1e-5 * abs(want.item())
    grads = dict(zip(P, torch.autograd.grad(want, list(P.values()))))
    for name, p in net.named_parameters():
        g, gp = grads[name], p.grad
        _close(gp, g)
        # Adam's first step: m^ = g, v^ = g^2
        torch.testing.assert_close(
            p.detach(), w0[name] - lr * gp / (gp.abs() + 1e-8), rtol=0,
            atol=1e-4 * lr)
        big = g.abs() > 1e-4 * g.abs().max()
        want_step = w0[name] - lr * g / (g.abs() + 1e-8)
        torch.testing.assert_close(p.detach()[big], want_step[big], rtol=0,
                                   atol=1e-3 * lr)


def test_no_edge_row_tensor_is_saved():
    """Every tensor autograd keeps for the backward of a step: none has a
    row per edge and more than a head's worth of columns (per-edge head
    scalars would be allowed; none is kept at all)."""
    net = _net()
    prob = Problem(net)
    e_real = prob.n_edges
    e_rows = {e_real, prob.tables.graph.senders.numel(),
              e_real + prob.x.shape[0]}
    assert prob.x.shape[0] not in e_rows
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = net(prob.tables.graph, prob.x,
                  **prob.tables.net_kwargs(distributed=False))
    out.sum().backward()
    assert saved
    wide = [s for s in saved if s and s[0] in e_rows
            and int(np.prod(s[1:], dtype=np.int64)) > max(HEADS)]
    assert wide == [], wide


def test_gat_config_and_problem():
    cfg = lg.ppi_gat_config(num_nodes=200, num_edges=1500, d_graph=1)
    assert (cfg.heads, cfg.head_dim, cfg.residual_layers) == (
        (4, 4, 6), (256, 256, 121), (1,))
    assert (cfg.feat_dim, cfg.label_dim, cfg.loss, cfg.lr) == (
        50, 121, 'bce', 0.005)
    # loss and label count follow from the model and its last head width
    assert (lg.LargeGraphConfig().loss, lg.LargeGraphConfig().label_dim) == (
        'mse', 1)
    assert lg.ppi_gat_config(head_dim=(8, 8, 7)).label_dim == 7
    assert (DistributedGATNet.loss, DistributedPNANet.loss) == ('bce', 'mse')
    part, feats, labels, tmask, vmask, efeats, _, kernel = lg.build_problem(
        cfg, 'cpu')
    assert kernel == 'csr' and efeats is None
    assert feats.shape[-1] == 50 and labels.shape[-1] == 121
    assert set(np.unique(labels[part.node_mask])) == {0.0, 1.0}
    # labels both ways in fair shares, and not the node's own features alone
    assert 0.2 < labels[part.node_mask].mean() < 0.8
    # the csr layout whatever the kernel named
    assert lg.build_problem(lg.ppi_gat_config(
        num_nodes=200, num_edges=1500, d_graph=1, kernel='generic'),
        'cpu')[-1] == 'csr'
    with pytest.raises(ValueError):
        lg.build_problem(lg.LargeGraphConfig(model='gcn'), 'cpu')


def test_cli_gat_one_rank():
    """``--model gat`` at the PPI widths on a few hundred nodes (at the
    paper's lr 0.005 Adam overshoots on so few nodes; 5e-4 falls)."""
    from pna_tpu_torch.cli import train_largegraph as cli
    net, hist = cli.main(['--model', 'gat', '--nodes', '300', '--edges',
                          '3000', '--d_graph', '1', '--steps', '4',
                          '--eval_every', '2', '--lr', '5e-4'], device='cpu')
    assert isinstance(net, DistributedGATNet)
    assert net.layers[0].W.shape == (1024, 50)        # 4 x 256 from 50
    assert net.layers[2].W.shape == (6 * 121, 1024)
    assert net.layers[1].skip is not None and net.layers[0].skip is None
    losses = [h['train_loss'] for h in hist]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert 'val_loss' in hist[1]

    def config(argv):
        return cli.config_from_args(cli.build_parser().parse_args(argv))

    cfg = config(['--model', 'gat'])
    assert (cfg.feat_dim, cfg.lr, cfg.kernel, cfg.head_dim) == (
        50, 0.005, 'csr', (256, 256, 121))
    assert config(['--model', 'gat', '--lr', '0.01']).lr == 0.01
    cfg = config([])
    assert (cfg.model, cfg.feat_dim, cfg.lr, cfg.kernel) == (
        'pna', 8, 1e-3, 'auto')


def test_two_graph_ranks_equal_one(tmp_path):
    """``d_graph`` 2 over spawned gloo ranks (the halo exchange feeds each
    layer's sender table) against ``d_graph`` 1, from the same seed's
    weights: the same losses to float32 round-off."""
    kw = dict(num_nodes=240, num_edges=2400, heads=(2, 2, 3),
              head_dim=(8, 8, 4), steps=3, eval_every=100,
              seed=1)
    _, one = lg.train_largegraph(lg.ppi_gat_config(d_graph=1, **kw),
                                 device='cpu')
    cfg2 = vars(lg.ppi_gat_config(d_graph=2, **kw))
    hists = ranks.run_world('largegraph_ranks', 2, tmp_path, cfg2, None)
    want = [h['train_loss'] for h in one]
    for hist in hists:
        got = [h['train_loss'] for h in hist]
        np.testing.assert_allclose(got, want, rtol=2e-5)


def test_neighbor_mean_labels_follow_the_neighbourhood():
    send, recv = graph_case(200, 2000)
    feats = np.random.RandomState(0).randn(200, FEAT).astype(np.float32)
    y = lg.neighbor_mean_labels(send, recv, feats, 200, 7, seed=4)
    assert y.shape == (200, 7) and y.dtype == np.float32
    # a node's own features alone do not give its labels: move a neighbour
    feats2 = feats.copy()
    feats2[send[recv == 0]] += 5.0
    y2 = lg.neighbor_mean_labels(send, recv, feats2, 200, 7, seed=4)
    assert not np.array_equal(y2[0], y[0]) or not np.array_equal(y2, y)
