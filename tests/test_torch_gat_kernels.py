"""The GAT attention kernels' plain versions (``ops/csr_gat.py``), their
layout, and their autograd function, on the CPU.

The plain versions are what the kernels are held to bit for bit on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here they are held to
the plain reference's aggregation (``pna_tpu_torch/reference/gat.py::
attention``), which sums in another order: every tolerance below is float32
round-off of sums of at most a few hundred terms, rtol 2e-5 and atol 2e-6
of the tensor's largest magnitude (about 100 ulps; a gradient's sums
cancel, so its small elements carry the round-off of its large terms), far
under what a wrong edge, head or weight would move (order 1e-2)."""

import numpy as np
import pytest
import torch

from pna_tpu_torch.ops import csr_gat as cg
from pna_tpu_torch.reference import gat as ref

RTOL, ATOL = 2e-5, 2e-6


def assert_close(got, want):
    torch.testing.assert_close(
        got, want, rtol=RTOL,
        atol=ATOL * max(1.0, float(want.abs().max())))


def attention_case(heads, f, seg=cg.SEG, seed=0, n=40, ghost=4, e=600):
    """A receiver-sorted layout of ``n`` receivers and a sender table of
    ``n + ghost`` rows (a partition's own rows, then its halo's): senders
    power-law-like, one of them holding ~40% of the edges (a hub of ~270,
    split at ``seg`` 128), node 3 with no in-edges, node 5 with many; the
    table's rows, attention vectors and scores drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    nt = n + ghost
    recv = torch.randint(0, n, (e,), generator=g)
    recv[recv == 3] = 5
    rank = torch.rand(e, generator=g)
    snd = (rank ** 3 * nt).long().clamp(max=nt - 1)
    snd[torch.rand(e, generator=g) < 0.4] = 7
    order = torch.argsort(recv, stable=True)
    recv, snd = recv[order], snd[order]
    ptr = torch.searchsorted(recv, torch.arange(n + 1)).to(torch.int32)
    lay = cg.build_gat_layout(ptr, snd.to(torch.int32), nt, seg=seg)
    hw = torch.randn(nt, heads * f, generator=g)
    a_src = torch.randn(heads, f, generator=g) / f ** 0.5
    a_dst = torch.randn(heads, f, generator=g) / f ** 0.5
    s_src, s_dst = cg.head_scores(hw, a_src, a_dst, n)
    return dict(lay=lay, hw=hw, a_src=a_src, a_dst=a_dst, s_src=s_src,
                s_dst=s_dst, senders=snd, receivers=recv, n=n, nt=nt)


def _ref_graph(c):
    return ref.graph_of(c['senders'], c['receivers'], c['n'])


SHAPES = [(4, 8), (6, 5), (2, 40), (3, 121)]


@pytest.mark.parametrize("heads,f", SHAPES)
def test_plain_forward_is_the_reference_attention(heads, f):
    c = attention_case(heads, f)
    out, m, l = cg.csr_gat_attend_plain(c['hw'], c['s_src'], c['s_dst'],
                                        c['lay'])
    want = ref.attention(c['hw'], c['a_src'], c['a_dst'], _ref_graph(c))
    assert_close(out, want.reshape(c['n'], -1))
    # the kept statistics: each node's largest logit and the sum of the
    # exponentials shifted by it (at least the largest one's, 1)
    assert torch.all(l >= 1.0) and torch.isfinite(m).all()


@pytest.mark.parametrize("heads,f", SHAPES)
@pytest.mark.parametrize("seg", [cg.SEG, 3])
def test_gradients_are_the_reference_gradients(heads, f, seg):
    """``gat_attend``'s gradients of hw and of both attention vectors (the
    plain backward: the receiver pass, the sender segments, a hub's merge
    in runs at ``seg`` 3) against autograd through the reference."""
    c = attention_case(heads, f, seg=seg)
    if seg == 3:       # runs of several slots
        assert int(c['lay'].split_slot.diff().max()) > cg.RUNS
    go = torch.randn(c['n'], heads * f, generator=torch.Generator()
                     .manual_seed(9))
    leaves = [c['hw'].clone().requires_grad_(True),
              c['a_src'].clone().requires_grad_(True),
              c['a_dst'].clone().requires_grad_(True)]
    s_src, s_dst = cg.head_scores(leaves[0], leaves[1], leaves[2], c['n'])
    out = cg.gat_attend(*leaves, s_src, s_dst, c['lay'])
    got = torch.autograd.grad((out * go).sum(), leaves)
    rl = [x.clone().requires_grad_(True) for x in (c['hw'], c['a_src'],
                                                   c['a_dst'])]
    want_out = ref.attention(*rl, _ref_graph(c)).reshape(c['n'], -1)
    want = torch.autograd.grad((want_out * go).sum(), rl)
    for a, b in zip(got, want):
        assert_close(a, b)


def test_layout_covers_every_edge_and_row_once():
    c = attention_case(4, 8, seg=3)
    lay = c['lay']
    snd = c['senders'].numpy()
    # the sorted positions: each real edge once, by sender, stable
    perm = lay.sperm.long().numpy()
    assert sorted(perm.tolist()) == list(range(lay.n_edges))
    assert np.all(np.diff(snd[perm]) >= 0)
    assert np.all((np.diff(snd[perm]) > 0) | (np.diff(perm) > 0))
    lo, hi = lay.seg_lo.long().numpy(), lay.seg_hi.long().numpy()
    node = lay.seg_node.long().numpy()
    # every table row has a segment; segments tile the sorted positions
    assert set(node.tolist()) == set(range(lay.n_table))
    assert np.all(np.diff(node) >= 0) and np.all(hi - lo <= 3)
    assert np.array_equal(np.sort(np.concatenate(
        [np.arange(a, b) for a, b in zip(lo, hi)])), np.arange(lay.n_edges))
    assert np.all(snd[perm[np.concatenate(
        [np.arange(a, b) for a, b in zip(lo, hi)])]] == np.repeat(node,
                                                                  hi - lo))
    # a split node's segments take consecutive slots, in order
    slot = lay.seg_slot.long().numpy()
    split = lay.split_node.long().numpy()
    assert np.array_equal(np.unique(node[slot >= 0]), split)
    assert np.array_equal(slot[slot >= 0], np.arange(lay.n_slots))
    # each edge's receiver, in sender order
    assert np.array_equal(lay.srows.numpy(), c['receivers'].numpy()[perm])


def test_layout_is_kept_on_the_csr_layout():
    from pna_tpu_torch.ops.csr_bank import csr_layout
    c = attention_case(4, 8)
    e = c['senders'].numel()
    csr = csr_layout(c['lay'].ptr, torch.ones(e, dtype=torch.bool),
                     senders=c['senders'])
    a = cg.gat_layout(csr, c['nt'])
    assert cg.gat_layout(csr, c['nt']) is a
    assert cg.gat_layout(csr, c['nt'] + 1) is not a


def test_wrappers_refuse_what_the_kernels_do_not_take():
    c = attention_case(4, 8)
    with pytest.raises(ValueError):
        cg.csr_gat_attend(c['hw'][:, :-1].contiguous(), c['s_src'],
                          c['s_dst'], c['lay'])
    with pytest.raises(ValueError):
        cg.csr_gat_attend(c['hw'].double(), c['s_src'], c['s_dst'],
                          c['lay'])
    wide = attention_case(2, 257)
    with pytest.raises(ValueError):
        cg.csr_gat_attend(wide['hw'], wide['s_src'], wide['s_dst'],
                          wide['lay'])
    with pytest.raises(ValueError):
        cg.build_gat_layout(c['lay'].ptr, c['lay'].senders, c['n'] - 1)


def test_cpu_route_launches_nothing():
    cg.reset_launch_counts()
    c = attention_case(6, 5)
    out, m, l = cg.csr_gat_attend(c['hw'], c['s_src'], c['s_dst'], c['lay'])
    cg.csr_gat_attend_bwd(c['hw'], c['s_src'], c['s_dst'], out, m, l,
                          c['a_src'], c['a_dst'], torch.ones_like(out),
                          c['lay'])
    assert cg.launch_counts() == {'csr_gat_attend': 0,
                                  'csr_gat_attend_bwd': 0}
