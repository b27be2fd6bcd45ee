"""The segment table of K1 and of the fused kernels K3/K4, the row-to-node
array it holds for K2, and the plain version of the merge pass
(pna_tpu_torch.ops.csr_kernels.csr_segments, CSRSegments.row_node,
pna_tpu_torch.ops.csr_fused_kernels.merge_segment_sketches_plain), on the CPU.

The table cuts every node's edge range into segments of at most SEG edges.
The kernels reduce each segment on its own and merge a split node's partial
results in segment order; here the same is done in plain torch: K1's plain
sketch taken per segment (the segment pointers used as row pointers) and
merged must equal the sketch per node.  Max, min and tie counts select values
and must be equal; sums are added in another order and may differ by 1e-5 of
the magnitudes they add.

The JAX package has no counterpart of the table (its kernels walk fixed
chunks on an in-order grid); the per-node sketch it is held to here is the
port's plain K1, which tests/test_torch_csr_kernels.py holds to
pna_tpu.ops.pallas_kernels.sorted_moment_sketch."""

import os
import re

import numpy as np
import pytest
import torch

from pna_tpu_torch.graph import batch_graphs
from pna_tpu_torch.ops import csr_bank
from pna_tpu_torch.ops import csr_fused_kernels as fk
from pna_tpu_torch.ops import csr_kernels as ck
from tests.test_torch_csr_bank import _random_graphs
from tests.test_torch_cuda import segment_case, sketch_case

SEG = ck.SEG
F = 6

DEGREES = {
    "ordinary": lambda rng: rng.randint(0, 5, 200),
    "boundaries": lambda rng: np.array([0, SEG - 1, SEG, SEG + 1, 0, 2 * SEG,
                                        2 * SEG + 1, 1, 0]),
    "hub": lambda rng: np.concatenate([rng.randint(0, 4, 50), [1000],
                                       rng.randint(0, 4, 50)]),
    "all_empty": lambda rng: np.zeros(7, np.int64),
    "one_node": lambda rng: np.array([5 * SEG + 3]),
    "random_wide": lambda rng: rng.randint(0, 4 * SEG, 60),
    "first_and_last_split": lambda rng: np.array([SEG + 1, 2, 0, 3 * SEG]),
}


def _layout(name, pad=0, start=0):
    """ptr [N+1] int32 for the degree list ``name``; ``start`` rows before
    ptr[0] and ``pad`` rows after ptr[N] belong to no node."""
    deg = DEGREES[name](np.random.RandomState(len(name)))
    ptr = np.zeros(len(deg) + 1, np.int32)
    ptr[1:] = np.cumsum(deg)
    return torch.from_numpy(ptr + start), int(ptr[-1]) + start + pad


@pytest.mark.parametrize("name", sorted(DEGREES))
def test_segment_table_covers_every_edge_once(name):
    ptr, e = _layout(name, pad=9, start=2)
    segs = ck.csr_segments(ptr)
    n = ptr.numel() - 1
    assert segs.n_nodes == n
    sp = segs.seg_ptr.long()
    assert sp.numel() == segs.n_seg + 1 and sp.dtype == torch.int64
    node = (torch.arange(n) if segs.seg_node is None
            else segs.seg_node.long())
    length = sp[1:] - sp[:-1]
    # no segment exceeds SEG; the segments tile [ptr[0], ptr[N]) in order, so
    # every real edge is in exactly one and the pad rows are in none
    assert int(length.min()) >= 0 and int(length.max()) <= SEG
    assert int(sp[0]) == int(ptr[0]) and int(sp[-1]) == int(ptr[-1])
    # a node's segments are consecutive and in order: seg_node is
    # nondecreasing, takes every node, and each segment lies in its node's
    # range
    assert torch.all(node[1:] >= node[:-1])
    assert torch.equal(torch.unique(node), torch.arange(n))
    assert torch.all(sp[:-1] >= ptr.long()[node])
    assert torch.all(sp[1:] <= ptr.long()[node + 1])
    deg = (ptr[1:] - ptr[:-1]).long()
    per_node = torch.bincount(node, minlength=n)
    assert torch.equal(per_node, torch.clamp((deg + SEG - 1) // SEG, min=1))
    # an empty node has one empty segment; only a node's last segment may be
    # shorter than SEG
    assert torch.all(per_node[deg == 0] == 1)
    last = torch.ones_like(node, dtype=torch.bool)
    last[:-1] = node[1:] != node[:-1]
    assert torch.all(length[~last] == SEG)
    # the split nodes and their partial slots
    split = per_node > 1
    assert segs.n_split == int(split.sum())
    assert segs.n_part == int(per_node[split].sum())
    if segs.n_split == 0:
        assert segs.seg_ptr is ptr and segs.seg_slot is None
        return
    assert torch.equal(segs.split_node.long(), torch.nonzero(split)[:, 0])
    slot = segs.seg_slot.long()
    assert torch.all((slot >= 0) == split[node])
    assert torch.equal(slot[slot >= 0], torch.arange(segs.n_part))
    sptr = segs.split_ptr.long()
    assert torch.equal(sptr[1:] - sptr[:-1], per_node[split])
    # a split node's slots follow its segments in order
    first = torch.cumsum(per_node, 0) - per_node
    assert torch.equal(slot[first[split]], sptr[:-1])


def test_known_small_in_degree_costs_nothing():
    """Where collation says no node has more than SEG edges the table is the
    row pointers themselves, with no tensor made."""
    ptr, _ = _layout("ordinary")
    segs = ck.csr_segments(ptr, max_in_degree=4)
    assert segs.seg_ptr is ptr and segs.n_seg == ptr.numel() - 1
    assert segs.n_split == 0 and segs.seg_node is None
    # a bound above SEG is no proof: the degrees are read
    assert ck.csr_segments(_layout("hub")[0], max_in_degree=1000).n_split == 1
    assert ck.csr_segments(ptr, max_in_degree=1000).seg_ptr is ptr


def test_layout_carries_the_table_for_the_fused_bank():
    graphs = _random_graphs(np.random.RandomState(0))
    g = batch_graphs(graphs)
    layout = csr_bank.layout_from_graph(g)
    assert layout.segments.seg_ptr is layout.ptr        # ZINC-like degrees
    assert layout.segments.n_nodes == g.n_node_pad
    # built at a bank's first use only
    assert layout._segments is layout.segments
    assert csr_bank.layout_from_graph(g)._segments is None
    ptr, e = _layout("hub", pad=3)
    mask = torch.arange(e) < e - 3
    layout = csr_bank.csr_layout(ptr, mask, senders=torch.zeros(e).long())
    assert layout.segments.n_split == 1
    assert int(layout.segments.seg_ptr[-1]) == e - 3


def _segment_sketch(msg, ptr, with_ties):
    segs = ck.csr_segments(ptr)
    parts = ck.csr_moment_sketch_plain(msg, segs.seg_ptr, with_ties)
    return fk.merge_segment_sketches_plain(parts, segs), segs


@pytest.mark.parametrize("with_ties", [False, True])
@pytest.mark.parametrize("name", sorted(DEGREES))
def test_merged_segment_sketches_equal_node_sketch(name, with_ties):
    ptr, e = _layout(name, pad=5)
    rng = np.random.RandomState(3)
    msg = rng.randn(e, F).astype(np.float32)
    msg[ptr[-1]:] = 1e6                     # pad rows: in no statistic
    # tie material everywhere: each value drawn from a few levels
    msg[:, :2] = rng.randint(-2, 3, (e, 2))
    msg = torch.from_numpy(msg)
    got, _ = _segment_sketch(msg, ptr, with_ties)
    want = ck.csr_moment_sketch_plain(msg, ptr, with_ties)
    assert len(got) == len(want) == (6 if with_ties else 4)
    scale = ck.csr_moment_sketch_plain(msg.abs(), ptr)[0]
    assert torch.all((got[0] - want[0]).abs() <= 1e-5 * scale + 1e-6)
    assert torch.all((got[1] - want[1]).abs() <= 1e-5 * want[1] + 1e-6)
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)


def test_tie_straddling_a_segment_boundary_is_counted_once_per_edge():
    """The node of 3 SEG edges of ``segment_case`` reaches its max on the
    last edge of its first segment and the first of its second, its min
    either side of its second boundary: the merged counts are 2 and 2."""
    u, v, snd, ef, ke, ptr, tie_node = (
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        for x in segment_case())
    msg = fk.pretrans_messages_plain(u, v, snd, ptr, ef, ke)
    got, segs = _segment_sketch(msg, ptr, True)
    want = fk.csr_pretrans_sketch_plain(u, v, snd, ptr, ef, ke, True)
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    assert torch.all(got[4][tie_node] == 2) and torch.all(got[5][tie_node] == 2)
    # the two edges of each pair lie in different segments of the node
    first = int(torch.nonzero(segs.seg_node == tie_node)[0, 0])
    assert int(segs.seg_ptr[first + 1]) == int(ptr[tie_node]) + SEG
    per_seg = ck.csr_moment_sketch_plain(msg, segs.seg_ptr, True)
    assert torch.all(per_seg[4][first:first + 2] == 1)      # max: segments 1, 2
    assert torch.all(per_seg[5][first + 1:first + 3] == 1)  # min: segments 2, 3


def test_wrappers_take_and_check_the_table():
    u, v, snd, ef, ke, ptr, _ = (
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        for x in segment_case())
    segs = ck.csr_segments(ptr)
    with_table = fk.csr_pretrans_sketch(u, v, snd, ptr, ef, ke, True, segs)
    without = fk.csr_pretrans_sketch(u, v, snd, ptr, ef, ke, True)
    for a, b in zip(with_table, without):
        assert torch.equal(a, b)
    other = ck.csr_segments(ptr[:-1])
    with pytest.raises(ValueError, match="segment table"):
        fk.csr_pretrans_sketch(u, v, snd, ptr, ef, ke, True, other)
    fields = [torch.zeros_like(v)] * 4 + [with_table[2], with_table[3]]
    with pytest.raises(ValueError, match="segment table"):
        fk.csr_pretrans_dmsg(u, v, snd, ptr, *fields, ef, ke, segments=other)
    d_msg, _ = fk.csr_pretrans_dmsg(u, v, snd, ptr, *fields, ef, ke,
                                    segments=segs)
    assert torch.all(d_msg[int(ptr[-1]):] == 0)         # pad rows are 0


@pytest.mark.parametrize("f", [12, 75])
def test_k1_segment_sketches_merge_to_the_node_sketch(f):
    """K1's two passes in plain torch on ``sketch_case`` (a hub of 300, empty
    nodes, a tie on either side of two segment cuts, rows of no node before
    and after, an even and an odd width): the sketch per segment, merged,
    is the sketch per node."""
    msg, ptr, tie_node = sketch_case(f)
    msg, ptr = torch.from_numpy(msg), torch.from_numpy(ptr)
    for with_ties in (False, True):
        got, segs = _segment_sketch(msg, ptr, with_ties)
        want = ck.csr_moment_sketch_plain(msg, ptr, with_ties)
        scale = ck.csr_moment_sketch_plain(msg.abs(), ptr)[0]
        assert torch.all((got[0] - want[0]).abs() <= 1e-5 * scale + 1e-6)
        assert torch.all((got[1] - want[1]).abs() <= 1e-5 * want[1] + 1e-6)
        for g, w in zip(got[2:], want[2:]):
            assert torch.equal(g, w)
    assert segs.n_split == 4 and int((ptr[1:] == ptr[:-1]).sum()) >= 3
    assert torch.all(got[4][tie_node] == 2) and torch.all(got[5][tie_node] == 2)
    assert float(got[2].max()) == 100.0       # no row of no node entered


@pytest.mark.parametrize("name", sorted(DEGREES))
def test_row_node_is_the_receiver_of_every_row(name):
    """K2's receiver array, from the cut table and from the row pointers as
    the table: the node whose range holds the row, a value outside [0, N)
    before ptr[0] and from ptr[N] on; built once and kept."""
    ptr, e = _layout(name, pad=4, start=2)
    n = ptr.numel() - 1
    ids, valid = ck._row_segments(ptr, e)
    assert int((~valid).sum()) == 6
    for segs in (ck.csr_segments(ptr),
                 ck.CSRSegments(seg_ptr=ptr, n_seg=n, n_nodes=n)):
        got = segs.row_node(e)
        assert got.dtype == torch.int32 and got.shape == (e,)
        assert torch.equal(got[valid].long(), ids[valid])
        assert torch.all((got[~valid] < 0) | (got[~valid] >= n))
        assert segs.row_node(e) is got
        assert segs.row_node(e - 1).numel() == e - 1    # another row count


def test_k1_k2_wrappers_take_and_check_the_table():
    msg, ptr, _ = sketch_case()
    msg, ptr = torch.from_numpy(msg), torch.from_numpy(ptr)
    segs = ck.csr_segments(ptr)
    with_table = ck.csr_moment_sketch(msg, ptr, True, segments=segs)
    without = ck.csr_moment_sketch(msg, ptr, True)
    for a, b in zip(with_table, without):
        assert torch.equal(a, b)
    other = ck.csr_segments(ptr[:-1])
    with pytest.raises(ValueError, match="segment table"):
        ck.csr_moment_sketch(msg, ptr, True, segments=other)
    fields = [torch.ones_like(with_table[0])] * 4 + list(with_table[2:4])
    with pytest.raises(ValueError, match="segment table"):
        ck.csr_dmsg(msg, ptr, *fields, segments=other)
    d_msg = ck.csr_dmsg(msg, ptr, *fields, segments=segs)
    assert torch.equal(d_msg, ck.csr_dmsg(msg, ptr, *fields))
    assert torch.all(d_msg[int(ptr[-1]):] == 0)         # pad rows are 0
    assert torch.all(d_msg[:int(ptr[0])] == 0)


def test_python_mirrors_the_kernels_constants():
    """SEG is kSeg of csrc/pretrans_msg.cuh, the one constant both sides
    hold (the shared-memory account is the library's own)."""
    from pna_tpu_torch.ops import build
    with open(os.path.join(build.CSRC_DIR, "pretrans_msg.cuh")) as f:
        src = f.read()

    def const(name):
        m = re.search(rf"constexpr \w+ {name} = ([0-9* ]+);", src)
        return eval(m.group(1))            # digits, spaces and * only

    assert const("kSeg") == ck.SEG
