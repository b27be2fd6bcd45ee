"""The CUDA kernels on the card, held against their plain PyTorch versions
(marked ``cuda``; they skip without a card).  This file imports no JAX, so it
also runs on the GPU machine, where JAX is not installed:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

It also holds the layout cases the CPU tests of tests/test_torch_csr_kernels.py
share, and the pretrans inputs of the fused kernels K3/K4 that
tests/test_torch_csr_fused_kernels.py shares.  Tolerances: K1's sum and
sumsq rtol 1e-5, atol 1e-5, except the sum on the hub layout; that sum, K3's
and K4's d_v within 1e-5 of the summed magnitudes plus 1e-5 (the plain
version adds with atomics, in an order that changes from run to run, and a
sum of 1,200 terms that cancels has no relative bound: the hub's read
2.2e-5 off at one element in some runs and not in others); max, min and tie
counts exactly equal (the plain versions form the same messages bit for
bit); d_msg rtol 1e-5, atol 1e-6, on every row (K4 writes the rows outside
every range as 0, and so does K2).

``segment_case`` is the layout of whole and split nodes that
tests/test_torch_csr_segments.py shares."""

import numpy as np
import pytest
import torch

from pna_tpu_torch.ops import csr_bank
from pna_tpu_torch.ops import csr_fused_kernels as fk
from pna_tpu_torch.ops import csr_kernels as ck

F = 12
FE = 5
GHOST = 13
CASES = ["empty_nodes", "n_over_128", "hub", "clamped"]


def _ptr(recv, n):
    ptr = np.zeros(n + 1, np.int32)
    ptr[1:] = np.searchsorted(recv, np.arange(1, n + 1))
    return ptr


def layout_case(name):
    """(msg [E, F], ptr [N+1]) for one layout case; rows 5 and 7 duplicate
    their predecessors so max/min ties occur."""
    rng = np.random.RandomState(CASES.index(name))
    e_real = None
    if name == "empty_nodes":             # half the nodes have no edge
        n, e = 96, 400
        recv = np.sort(rng.randint(0, n // 2, e) * 2)
    elif name == "n_over_128":
        n, e = 300, 1500
        recv = np.sort(rng.randint(0, n, e))
    elif name == "hub":                   # a range longer than 256 edges
        n, e = 260, 2400
        recv = np.sort(np.where(rng.rand(e) < 0.5, 131, rng.randint(0, n, e)))
    elif name == "clamped":               # pad rows past the real edges
        n, e, e_real = 150, 1024, 700
        recv = np.full(e, n - 1)
        recv[:e_real] = np.sort(rng.randint(0, n, e_real))
    else:
        raise ValueError(name)
    msg = rng.randn(e, F).astype(np.float32)
    msg[5] = msg[4]
    msg[7] = msg[6]
    ptr = _ptr(recv, n)
    if e_real is not None:
        ptr[-1] = e
        msg[e_real:] = 1e6                # must never enter a statistic
        ptr = np.minimum(ptr, e_real).astype(np.int32)
    return msg, ptr


def valid_rows(ptr, e):
    rows = np.arange(e)
    return (rows >= ptr[0]) & (rows < ptr[-1])


def pretrans_inputs(ptr, e, f, seed, ghost=False, fe=FE):
    """(u [Nu, f], v [N, f], senders [e] int32, ef [e, FE], ke [FE, f]) for a
    layout.  Every third edge that shares its receiver with the edge before it
    repeats that edge's sender and edge features, so their messages tie.
    With ``ghost``, u has GHOST extra rows and every third sender points into
    them.  Rows past ptr[-1] carry the pad edges' sender N - 1 and garbage
    edge features that must never enter a statistic."""
    rng = np.random.RandomState(seed)
    n = len(ptr) - 1
    n_u = n + GHOST if ghost else n
    snd = rng.randint(0, n, e).astype(np.int32)
    if ghost:
        snd[::3] = n + rng.randint(0, GHOST, len(snd[::3]))
    ef = rng.randn(e, fe).astype(np.float32)
    recv = np.searchsorted(ptr[1:], np.arange(e), side='right')
    for i in range(1, e, 3):
        if recv[i] == recv[i - 1]:
            snd[i], ef[i] = snd[i - 1], ef[i - 1]
    valid = valid_rows(ptr, e)
    snd[~valid] = n - 1
    ef[~valid] = 1e6
    return (rng.randn(n_u, f).astype(np.float32),
            rng.randn(n, f).astype(np.float32), snd, ef,
            rng.randn(fe, f).astype(np.float32))


def segment_case(seed=11, f=F, fe=FE):
    """A layout of whole and split nodes with pad rows: in-degrees 0, 3,
    SEG - 1, SEG, SEG + 1, 0, 3 SEG, 1, 2 SEG + 5, 0, a hub of 300, then
    forty of 0..4, and 9 pad rows.  Either side of the first segment
    boundary of the node of 3 SEG edges lie two edges with one sender (u row
    +100) and one ef row, either side of its second boundary two with a u
    row of -100: its max and min are each reached once in two segments, so
    both tie counts are 2 at every feature.  Returns (u, v, snd, ef, ke, ptr,
    tie node) as numpy arrays."""
    seg = ck.SEG
    rng = np.random.RandomState(seed)
    deg = np.array([0, 3, seg - 1, seg, seg + 1, 0, 3 * seg, 1, 2 * seg + 5,
                    0, 300] + list(rng.randint(0, 5, 40)))
    n, tie_node = len(deg), 6
    ptr = np.zeros(n + 1, np.int32)
    ptr[1:] = np.cumsum(deg)
    e = int(ptr[-1]) + 9
    u, v, snd, ef, ke = pretrans_inputs(ptr, e, f, seed, fe=fe)
    snd[snd < 2] = 2
    u[0], u[1] = 100.0, -100.0
    lo = ptr[tie_node]
    for at, sender in ((lo + seg - 1, 0), (lo + 2 * seg - 1, 1)):
        snd[at:at + 2] = sender
        ef[at + 1] = ef[at]
    return u, v, snd, ef, ke, ptr, tie_node


def sketch_case(f=F, seed=13):
    """Messages for K1/K2 over ``segment_case``'s layout of whole and split
    nodes, moved 3 rows down (rows before ptr[0] belong to no node) with 9
    pad rows after: (msg [E, f], ptr, tie node).  Values are drawn from a few
    levels, so ties are everywhere; the node of 3 SEG edges holds +100 on
    either side of its first segment cut and -100 on either side of its
    second, so both its tie counts are 2 at every feature.  Rows of no node
    carry 1e6 and must enter nothing."""
    *_, ptr, tie_node = segment_case()
    ptr = ptr + 3
    rng = np.random.RandomState(seed)
    e = int(ptr[-1]) + 9
    msg = rng.randn(e, f).astype(np.float32)
    msg[:, ::2] = rng.randint(-2, 3, msg[:, ::2].shape)
    lo = ptr[tie_node]
    msg[lo + ck.SEG - 1:lo + ck.SEG + 1] = 100.0
    msg[lo + 2 * ck.SEG - 1:lo + 2 * ck.SEG + 1] = -100.0
    msg[:ptr[0]] = 1e6
    msg[ptr[-1]:] = 1e6
    return msg, ptr.astype(np.int32), tie_node


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernels_match_plain(case):
    _need_card()
    msg, ptr = layout_case(case)
    m, p = torch.from_numpy(msg).cuda(), torch.from_numpy(ptr).cuda()
    before = fk.launch_counts()
    for with_ties in (False, True):
        got = ck.csr_moment_sketch(m, p, with_ties)
        want = ck.csr_moment_sketch_plain(m, p, with_ties)
        if case == "hub":      # 1,200 terms that cancel: no relative bound
            _sum_close(got[0], want[0], m, p)
        else:
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
        for g, w in zip(got[2:], want[2:]):
            assert torch.equal(g, w)
    n = p.numel() - 1
    fields = [torch.randn(n, F, device='cuda') for _ in range(4)]
    fields += [got[2], got[3]]
    valid = torch.from_numpy(valid_rows(ptr, len(msg))).cuda()
    d = ck.csr_dmsg(m, p, *fields)
    torch.testing.assert_close(d, ck.csr_dmsg_plain(m, p, *fields),
                               rtol=1e-5, atol=1e-6)     # every row
    assert torch.all(d[~valid] == 0)             # written, not left over
    after = fk.launch_counts()
    assert after['csr_moment_sketch'] == before['csr_moment_sketch'] + 2
    assert after['csr_dmsg'] == before['csr_dmsg'] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_bank_matches_cpu(case):
    """The bank's forward and message gradient on the card (K1, K2) against
    the same bank on the CPU (plain versions)."""
    _need_card()
    msg, ptr = layout_case(case)
    em = torch.from_numpy(valid_rows(ptr, len(msg)))
    out = []
    for dev in ('cpu', 'cuda'):
        layout = csr_bank.csr_layout(torch.from_numpy(ptr).to(dev),
                                     em.to(dev))
        m = torch.from_numpy(msg).to(dev).requires_grad_(True)
        z = csr_bank.csr_raw_bank(m, layout, ('mean', 'max', 'min', 'std'))
        torch.sum(torch.sin(z * 0.7)).backward()
        out.append((z.detach().cpu(), m.grad.cpu()))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-4, atol=1e-5)
    assert torch.all(out[1][1][~em] == 0)


def _sum_close(got, want, rows, ptr):
    """A per-node sum agrees within 1e-5 of the summed magnitudes it adds
    (plus 1e-5): the two versions add in other orders."""
    scale = ck.csr_moment_sketch_plain(rows.abs(), ptr)[0]
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-5).all())


def _hold_csr(m, p, table, tie_node=None, seed=0):
    """K1 with and without ties and K2 on every row against their plain
    versions, with ``table`` as the segment table (None: the wrappers build
    it); returns K1's six outputs and K2's."""
    for with_ties in (False, True):
        got = ck.csr_moment_sketch(m, p, with_ties, segments=table)
        want = ck.csr_moment_sketch_plain(m, p, with_ties)
        _sum_close(got[0], want[0], m, p)
        _sum_close(got[1], want[1], m * m, p)
        for g, w in zip(got[2:], want[2:]):
            assert torch.equal(g, w)
    if tie_node is not None:
        assert torch.all(got[4][tie_node] == 2)
        assert torch.all(got[5][tie_node] == 2)
    gen = torch.Generator().manual_seed(seed)
    fields = [torch.randn(got[0].shape, generator=gen).cuda()
              for _ in range(4)]
    fields[2] /= got[4]
    fields[3] /= got[5]
    fields += [got[2], got[3]]
    d = ck.csr_dmsg(m, p, *fields, segments=table)
    torch.testing.assert_close(d, ck.csr_dmsg_plain(m, p, *fields),
                               rtol=1e-5, atol=1e-6)
    _, valid = ck._row_segments(p, m.shape[0])
    assert torch.all(d[~valid] == 0)
    return got + (d,)


def _coarse_table(ptr, cut):
    """A caller's own table of ``ptr`` (numpy), ranges cut at ``cut`` edges
    instead of SEG, on the card."""
    deg = np.diff(ptr)
    cuts, nodes, slots, split_node, split_ptr = [int(ptr[0])], [], [], [], [0]
    for i, d in enumerate(deg):
        k = max(1, -(-int(d) // cut))
        for j in range(k):
            cuts.append(int(ptr[i]) + min(int(d), cut * (j + 1)))
            nodes.append(i)
            slots.append(split_ptr[-1] + j if k > 1 else -1)
        if k > 1:
            split_node.append(i)
            split_ptr.append(split_ptr[-1] + k)
    i32 = dict(dtype=torch.int32, device='cuda')
    return ck.CSRSegments(
        seg_ptr=torch.tensor(cuts, **i32), n_seg=len(nodes), n_nodes=len(deg),
        n_split=len(split_node), n_part=split_ptr[-1],
        seg_node=torch.tensor(nodes, **i32),
        seg_slot=torch.tensor(slots, **i32),
        split_node=torch.tensor(split_node, **i32),
        split_ptr=torch.tensor(split_ptr, **i32))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 33, 70, 75, 128, 300])
def test_cuda_csr_split_nodes_match_plain(f):
    """K1 and K2 on whole and split nodes (in-degrees 0, SEG, SEG + 1, a hub
    of 300), rows of no node before and after, ties across segment
    boundaries, at widths whose rows start on 4-, 8- and 16-byte boundaries.
    With the table given, built by the wrappers, uncut (the row pointers: the
    hub is one segment of several staged spans) and cut at 80 edges (split
    nodes whose partials are continued); and on a msg that starts 4 bytes off
    a 16-byte boundary."""
    _need_card()
    msg, ptr, tie_node = sketch_case(f)
    m, p = torch.from_numpy(msg).cuda(), torch.from_numpy(ptr).cuda()
    segs = ck.csr_segments(p)
    assert segs.n_split == 4 and segs.n_part == 2 + 3 + 3 + 10
    n = p.numel() - 1
    whole = ck.CSRSegments(seg_ptr=p, n_seg=n, n_nodes=n)
    coarse = _coarse_table(ptr, 80)
    assert coarse.n_split == 2
    runs = [_hold_csr(m, p, table, tie_node)
            for table in (segs, None, whole, coarse)]
    off = torch.empty(m.numel() + 1, device='cuda')[1:].view(m.shape)
    off.copy_(m)
    assert off.data_ptr() % 16 == 4
    runs.append(_hold_csr(off, p, segs, tie_node))
    # max, min and tie counts do not depend on the table; nor does d_msg
    for other in runs[1:]:
        for a, b in zip(runs[0][2:], other[2:]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_csr_same_bits_every_run():
    """No atomics and a fixed merge order: two runs of K1 and K2 on a hub
    (a node of 13,107 edges among 4,096) give the same bits."""
    _need_card()
    rng = np.random.RandomState(3)
    n, e = 4096, 65536
    recv = rng.randint(0, n, e)
    recv[: e // 5] = 17
    ptr = _ptr(np.sort(recv), n)
    m = torch.from_numpy(rng.randn(e, 70).astype(np.float32)).cuda()
    p = torch.from_numpy(ptr).cuda()
    segs = ck.csr_segments(p)
    assert segs.n_split == 1
    assert segs.n_part == -(-int(np.diff(ptr).max()) // ck.SEG) > 400
    first = _hold_csr(m, p, segs)
    again = _hold_csr(m, p, segs)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_csr_many_tiles_per_block():
    """120,000 nodes are more tiles than one round of resident blocks takes:
    every block of K1 stages several spans in turn in its two buffers, and
    two split nodes lie far apart."""
    _need_card()
    rng = np.random.RandomState(5)
    deg = rng.randint(0, 5, 120_000)
    deg[[7, 90_001]] = 500
    ptr = np.zeros(len(deg) + 1, np.int32)
    ptr[1:] = np.cumsum(deg)
    m = torch.from_numpy(
        rng.randn(int(ptr[-1]) + 40, F).astype(np.float32)).cuda()
    dup = torch.arange(1, m.shape[0], 5, device='cuda')
    m[dup] = m[dup - 1]                      # tie material
    p = torch.from_numpy(ptr).cuda()
    segs = ck.csr_segments(p)
    assert segs.n_split == 2
    _hold_csr(m, p, segs)


@pytest.mark.cuda
def test_cuda_csr_refuses_a_row_shared_memory_cannot_hold():
    """A row of 12,289 floats is over one staging buffer: K1's wrapper raises
    in words before any launch; 12,288, the most that fits, still runs (one
    row a span)."""
    _need_card()
    p = torch.tensor([0, 2, 2, 5], dtype=torch.int32, device='cuda')
    m = torch.randn(6, 12289, device='cuda')
    with pytest.raises(ValueError, match="shared memory"):
        ck.csr_moment_sketch(m, p)
    _hold_csr(m[:, :12288].contiguous(), p, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES + ["ghost"])
def test_cuda_pretrans_kernels_match_plain(case, dtype):
    """K3 (with and without ties and edge features) and K4 against their
    plain versions, on the layout cases and on a ghost sender table."""
    _need_card()
    msg, ptr = layout_case("n_over_128" if case == "ghost" else case)
    u, v, snd, ef, ke = (torch.from_numpy(x).cuda() for x in pretrans_inputs(
        ptr, len(msg), F, seed=7, ghost=case == "ghost"))
    v, ef, ke = v.to(dtype), ef.to(dtype), ke.to(dtype)
    p = torch.from_numpy(ptr).cuda()
    valid = torch.from_numpy(valid_rows(ptr, len(msg))).cuda()
    before = fk.launch_counts()
    for e_args in ((ef, ke), (None, None)):
        for with_ties in (False, True):
            got = fk.csr_pretrans_sketch(u, v, snd, p, *e_args, with_ties)
            want = fk.csr_pretrans_sketch_plain(u, v, snd, p, *e_args,
                                                with_ties)
            m = fk.pretrans_messages_plain(u, v, snd, p, *e_args)
            _sum_close(got[0], want[0], m, p)
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
            for g, w in zip(got[2:], want[2:]):
                assert torch.equal(g, w)
        assert float(got[4].max()) >= 2          # the repeated edges tie
        n = p.numel() - 1
        fields = [torch.randn(n, F, device='cuda') for _ in range(4)]
        fields[2] /= got[4]
        fields[3] /= got[5]
        fields += [got[2], got[3]]
        d_k, dv_k = fk.csr_pretrans_dmsg(u, v, snd, p, *fields, *e_args)
        d_p, dv_p = fk.csr_pretrans_dmsg_plain(u, v, snd, p, *fields, *e_args)
        torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-6)
        assert torch.all(d_k[~valid] == 0)       # written, not left over
        _sum_close(dv_k, dv_p, d_p, p)
    after = fk.launch_counts()
    assert after['csr_pretrans_sketch'] == before['csr_pretrans_sketch'] + 4
    assert after['csr_pretrans_dmsg'] == before['csr_pretrans_dmsg'] + 2


def _segment_inputs(dtype, fe=FE):
    u, v, snd, ef, ke, ptr, tie_node = segment_case(fe=fe)
    u, v, snd, ef, ke, p = (torch.from_numpy(x).cuda()
                            for x in (u, v, snd, ef, ke, ptr))
    return (u, v.to(dtype), snd, p, ef.to(dtype), ke.to(dtype)), tie_node


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fe", [FE, 70])
def test_cuda_pretrans_split_nodes_match_plain(dtype, fe):
    """K3 and K4 on whole and split nodes (in-degrees 0, SEG, SEG + 1, a
    hub), with ties across segment boundaries, at Fe = 5 and 70 (one and two
    terms past the last whole group of four).  With the table given and
    built by the wrapper."""
    _need_card()
    (u, v, snd, p, ef, ke), tie_node = _segment_inputs(dtype, fe)
    segs = ck.csr_segments(p)
    assert segs.n_split == 4 and segs.n_part == 2 + 3 + 3 + 10
    m = fk.pretrans_messages_plain(u, v, snd, p, ef, ke)
    for table in (segs, None):
        for with_ties in (False, True):
            got = fk.csr_pretrans_sketch(u, v, snd, p, ef, ke, with_ties,
                                         table)
            want = fk.csr_pretrans_sketch_plain(u, v, snd, p, ef, ke,
                                                with_ties)
            _sum_close(got[0], want[0], m, p)
            _sum_close(got[1], want[1], m * m, p)
            for g, w in zip(got[2:], want[2:]):
                assert torch.equal(g, w)
        assert torch.all(got[4][tie_node] == 2)
        assert torch.all(got[5][tie_node] == 2)
        fields = [torch.randn(p.numel() - 1, F, device='cuda')
                  for _ in range(4)]
        fields[2] /= got[4]
        fields[3] /= got[5]
        fields += [got[2], got[3]]
        d_k, dv_k = fk.csr_pretrans_dmsg(u, v, snd, p, *fields, ef, ke, table)
        d_p, dv_p = fk.csr_pretrans_dmsg_plain(u, v, snd, p, *fields, ef, ke)
        torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-6)
        _sum_close(dv_k, dv_p, d_p, p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_pretrans_same_bits_every_run(dtype):
    """No atomics and a fixed merge order: two runs of K3 and K4 on split
    nodes give the same bits."""
    _need_card()
    (u, v, snd, p, ef, ke), _ = _segment_inputs(dtype)
    segs = ck.csr_segments(p)
    runs = []
    for _ in range(2):
        k6 = fk.csr_pretrans_sketch(u, v, snd, p, ef, ke, True, segs)
        fields = [torch.full_like(k6[0], c) for c in (0.3, -0.2)]
        fields += [0.5 / k6[4], -0.7 / k6[5], k6[2], k6[3]]
        runs.append(k6 + fk.csr_pretrans_dmsg(u, v, snd, p, *fields, ef, ke,
                                              segs))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [F, 70, 128])
def test_cuda_pretrans_walks_segments_of_any_length(dtype, f):
    """A caller's table need not be cut at SEG: with the row pointers as the
    table (no node split), nodes of 100, 300 and 3 SEG edges are longer than a
    sub-tile (64 edges at F = 12 and 70, 36 at F = 128) and are walked in
    several, each continuing the last; and a table cut at 80 edges has split
    nodes whose partials are continued.  Ties straddle the sub-tiles' ends."""
    _need_card()
    *_, ptr, tie_node = segment_case()
    deg = np.diff(ptr)
    deg[1] = 100
    ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e = int(ptr[-1]) + 9
    u, v, snd, ef, ke = pretrans_inputs(ptr, e, f, seed=11)
    snd[snd < 2] = 2
    u[0], u[1] = 100.0, -100.0
    lo = ptr[tie_node]
    # the max either side of edge 64 of the node of 3 SEG, the min either
    # side of edge 36: where sub-tiles of 64 and of 36 edges end
    for at, sender in ((lo + 63, 0), (lo + 35, 1)):
        snd[at:at + 2] = sender
        ef[at + 1] = ef[at]
    u, v, snd, ef, ke, p = (torch.from_numpy(x).cuda()
                            for x in (u, v, snd, ef, ke, ptr))
    v, ef, ke = v.to(dtype), ef.to(dtype), ke.to(dtype)
    n = p.numel() - 1
    whole = ck.CSRSegments(seg_ptr=p, n_seg=n, n_nodes=n)
    # the same table type cut at 80 edges: the hub of 300 has 4 segments,
    # the nodes of 100 and 3 SEG two each
    coarse = _coarse_table(ptr, 80)
    assert coarse.n_split == 3
    m = fk.pretrans_messages_plain(u, v, snd, p, ef, ke)
    for table in (whole, coarse):
        for with_ties in (False, True):
            got = fk.csr_pretrans_sketch(u, v, snd, p, ef, ke, with_ties,
                                         table)
            want = fk.csr_pretrans_sketch_plain(u, v, snd, p, ef, ke,
                                                with_ties)
            _sum_close(got[0], want[0], m, p)
            _sum_close(got[1], want[1], m * m, p)
            for g, w in zip(got[2:], want[2:]):
                assert torch.equal(g, w)
        assert torch.all(got[4][tie_node] == 2)
        assert torch.all(got[5][tie_node] == 2)
        fields = [torch.randn(n, f, device='cuda') for _ in range(4)]
        fields[2] /= got[4]
        fields[3] /= got[5]
        fields += [got[2], got[3]]
        d_k, dv_k = fk.csr_pretrans_dmsg(u, v, snd, p, *fields, ef, ke, table)
        d_p, dv_p = fk.csr_pretrans_dmsg_plain(u, v, snd, p, *fields, ef, ke)
        torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-6)
        _sum_close(dv_k, dv_p, d_p, p)


@pytest.mark.cuda
def test_cuda_pretrans_many_tiles_per_block():
    """120,000 nodes are more segments than one round of resident blocks
    takes: every block walks several tiles and sub-tiles, reusing its shared
    memory, and two split nodes lie far apart."""
    _need_card()
    rng = np.random.RandomState(5)
    deg = rng.randint(0, 5, 120_000)
    deg[[7, 90_001]] = 500
    ptr = np.zeros(len(deg) + 1, np.int32)
    ptr[1:] = np.cumsum(deg)
    u, v, snd, ef, ke = (torch.from_numpy(x).cuda() for x in pretrans_inputs(
        ptr, int(ptr[-1]) + 40, F, seed=5))
    p = torch.from_numpy(ptr).cuda()
    segs = ck.csr_segments(p)
    assert segs.n_split == 2
    got = fk.csr_pretrans_sketch(u, v, snd, p, ef, ke, True, segs)
    want = fk.csr_pretrans_sketch_plain(u, v, snd, p, ef, ke, True)
    m = fk.pretrans_messages_plain(u, v, snd, p, ef, ke)
    _sum_close(got[0], want[0], m, p)
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    fields = [torch.randn(len(deg), F, device='cuda') for _ in range(4)]
    fields += [got[2], got[3]]
    d_k, dv_k = fk.csr_pretrans_dmsg(u, v, snd, p, *fields, ef, ke, segs)
    d_p, dv_p = fk.csr_pretrans_dmsg_plain(u, v, snd, p, *fields, ef, ke)
    torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-6)
    _sum_close(dv_k, dv_p, d_p, p)


@pytest.mark.cuda
def test_cuda_pretrans_refuses_what_shared_memory_cannot_hold():
    """Fe = 400 at F = 70 is over a block's shared memory: the wrappers raise
    before any launch; Fe = 388, the most that fits, still runs."""
    _need_card()
    u, v, snd, ef, ke, ptr, _ = segment_case(f=70, fe=400)
    u, v, snd, ef, ke, p = (torch.from_numpy(x).cuda()
                            for x in (u, v, snd, ef, ke, ptr))
    with pytest.raises(ValueError, match="shared memory"):
        fk.csr_pretrans_sketch(u, v, snd, p, ef, ke)
    ef, ke = ef[:, :388].contiguous(), ke[:388].contiguous()
    got = fk.csr_pretrans_sketch(u, v, snd, p, ef, ke, True)
    want = fk.csr_pretrans_sketch_plain(u, v, snd, p, ef, ke, True)
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
