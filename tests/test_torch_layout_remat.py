"""``remat=True`` of PNANetMolecules: against the JAX net under
``nn.remat`` on the same weights (its parameter tree maps as without
remat), at tests/test_torch_layout_nets.py's float32 tolerances, and against
the port's own step without remat, with dropout on, which it repeats
exactly: loss, gradients, batch-norm statistics and the dropout generator's
state are equal."""

import jax
import pytest
import torch

from pna_tpu.nn.nets import PNANetMolecules as JNet
from pna_tpu_torch.data import molecules as tmol
from pna_tpu_torch.nn.nets import PNANetMolecules
from pna_tpu_torch.train.step import loss_and_grads
from pna_tpu_torch.weights import from_jax
from tests.test_torch_layout_nets import (AGGS, LAYOUT, NET, PORT_KERNEL,
                                          _batches, _hold, _jax_step, _np)


def test_remat_net_matches_jax_remat():
    """remat=True in both packages (the JAX layers under nn.remat), the JAX
    net on its bucketed batch under 'auto', the port's on its CSR batch
    under 'csr': the parameter tree maps as without remat, and loss and
    gradients agree."""
    recs, tg, tl, jg, jl = _batches(LAYOUT['auto'])
    avg_d = tmol.ZincDataset(recs, [], []).avg_d()
    jnet = JNet(**NET, aggregators=AGGS, avg_d=avg_d, kernel='auto',
                remat=True)
    var, l_j, g_j, _ = _jax_step(jnet, jg, jl)
    plain = _np(JNet(**NET, aggregators=AGGS, avg_d=avg_d).init(
        {'params': jax.random.PRNGKey(0)}, jg, jg.node_feats.squeeze(-1),
        jg.edge_feats.squeeze(-1), train=False))
    assert (jax.tree_util.tree_structure(var)
            == jax.tree_util.tree_structure(plain))
    net = PNANetMolecules(**NET, aggregators=AGGS, avg_d=avg_d,
                          kernel=PORT_KERNEL['auto'], remat=True,
                          device='cpu')
    net.load_state_dict(from_jax(var['params'], var['batch_stats']))
    _hold(net, loss_and_grads(net, tg, tl), l_j, g_j)


@pytest.mark.parametrize("kernel", ['csr', 'auto'])
def test_remat_step_repeats_plain_step(kernel):
    """With dropout 0.2 and in-feature dropout 0.1: two training steps of
    the remat net and of the plain net from the same weights and generator
    seed give equal losses, gradients, batch-norm statistics and generator
    states (the recompute redraws the forward's masks, normalises with its
    shift and leaves the statistics moved once).  'auto' runs the generic
    backend on the CPU."""
    recs = tmol.synthetic_zinc(8, seed=11)
    g, y = tmol.collate_records(recs)
    avg_d = tmol.ZincDataset(recs, [], []).avg_d()
    nets = [PNANetMolecules(**NET, aggregators=AGGS, avg_d=avg_d,
                            kernel=kernel, dropout=0.2, in_feat_dropout=0.1,
                            remat=remat, device='cpu', seed=5)
            for remat in (False, True)]
    for _ in range(2):
        losses = [loss_and_grads(net, g, y) for net in nets]
        assert torch.equal(losses[0], losses[1])
        plain, remat = (dict(n.named_parameters()) for n in nets)
        for k in plain:
            assert torch.equal(plain[k].grad, remat[k].grad), k
        sd = [n.state_dict() for n in nets]
        for k in sd[0]:
            assert torch.equal(sd[0][k], sd[1][k]), k
        assert torch.equal(nets[0].generator.get_state(),
                           nets[1].generator.get_state())
    # dropout is on: a third net drawing other masks gives another loss
    other = PNANetMolecules(**NET, aggregators=AGGS, avg_d=avg_d,
                            kernel=kernel, dropout=0.2, in_feat_dropout=0.1,
                            remat=True, device='cpu', seed=6)
    other.load_state_dict(nets[0].state_dict())
    assert not torch.equal(loss_and_grads(other, g, y),
                           loss_and_grads(nets[0], g, y))
