"""The FLOP and byte counts against values worked by hand, and the FLOP
count against PyTorch's own count of the reference's products."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, weights
from portbench.generators import zinc_like_molecules
from portbench.reference import pna as ref

# L 1, hidden 4 -> out 4, 2 towers (2 features in, 2 out each), 3 edge
# features, 4 aggregators x 3 scalers
TINY = dict(L=1, hidden_dim=4, out_dim=4, towers=2, edge_feat=True,
            edge_dim=3, aggregators=('mean', 'max', 'min', 'std'),
            scalers=('identity', 'amplification', 'attenuation'),
            divide_input_first=True, divide_input_last=True, residual=True,
            pretrans_layers=1, posttrans_layers=1, graph_norm=True,
            batch_norm=True, readout='sum', gru=False, dropout=0.0,
            in_feat_dropout=0.0, num_atom_type=28, num_bond_type=4,
            feat_dim=3)


def test_flops_by_hand():
    # 5 nodes, 8 edges, 2 graphs:
    # node halves 2 x 2 x 5 nodes x 2 towers x 2 x 2 = 160
    # edge term   2 x 8 edges x 3 x 2 towers x 2     = 192
    # posttrans   2 x 5 x 2 towers x 26 x 2          = 1040
    # mixing      2 x 5 x 4 x 4                      = 160
    # readout     2 x 2 graphs x (4*2 + 2*1 + 1*1)   = 44
    assert counts.forward_flops(TINY, 'molecules', 5, 8, 2) == 1596
    assert counts.step_flops(TINY, 'molecules', 5, 8, 2) == 3 * 1596
    # the node head adds its embedding (2 x 5 x 3 x 4 = 120) and reads out
    # every node (2 x 5 x 11 = 110) in place of every graph
    assert counts.forward_flops(TINY, 'node', 5, 8, 0) == 1596 - 44 + 120 \
        + 110


def test_bytes_by_hand():
    # 10 message rows, 4 nodes, 2 features, float32
    assert counts.k1_bytes(10, 4, 2) == 4 * 10 * 2 + 6 * 4 * 4 * 2   # 272
    assert counts.k2_bytes(10, 4, 2) == 2 * 4 * 10 * 2 + 4 * 10 \
        + 6 * 4 * 4 * 2                                              # 392
    assert counts.row_sum_bytes(10, 4, 2) == 80 + 40 + 20 + 32       # 172
    peak = dict(hbm_bytes_per_s=1e3, float32=1e3)
    assert counts.bound_s(172, 20, peak) == 0.172
    assert counts.bound_s(10, 500, peak) == 0.5


def test_flops_match_torch_count_of_the_reference():
    """The reference forms exactly the products the count counts."""
    net = dict(TINY, L=2, hidden_dim=10, out_dim=6, towers=2, edge_dim=5)
    records = zinc_like_molecules(7, seed=3)
    batch = dict(ref.molecule_batch(records, 'cpu'), avg_log=1.3)
    P = weights.draw(ref.param_spec(net, 'molecules'), 5, 'cpu')
    stats = {k: v for k, v in P.items() if ref.is_statistic(k)}
    with FlopCounterMode(display=False) as fc:
        ref.molecules_loss(P, net, batch, stats, tf32=False)
    n, e = batch['atom'].shape[0], batch['senders'].shape[0]
    assert fc.get_total_flops() == counts.forward_flops(
        net, 'molecules', n, e, len(records))

    graph = dict(senders=batch['senders'], receivers=batch['receivers'],
                 deg=ref.in_degrees(batch['receivers'], n),
                 feats=torch.randn(n, net['feat_dim']),
                 y=torch.randn(n), train=torch.arange(n), avg_log=1.3)
    net = dict(net, graph_norm=False, edge_feat=False, edge_dim=0)
    P = weights.draw(ref.param_spec(net, 'node'), 5, 'cpu')
    stats = {k: v for k, v in P.items() if ref.is_statistic(k)}
    with FlopCounterMode(display=False) as fc:
        ref.node_loss(P, net, graph, stats, tf32=False)
    assert fc.get_total_flops() == counts.forward_flops(net, 'node', n, e, 0)
