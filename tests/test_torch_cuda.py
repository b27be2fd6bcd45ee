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
tests/test_torch_csr_segments.py shares.  The last tests hold the sparse
bank's routing on the card (K1/K2 for mean/sum/max/min/var/std, plain torch
for the other aggregators) against the CPU's segment form, and the bank on
a node no edge reaches.  The multitask tests hold the dense GNN (PNA, MPNN,
GCN, GAT, GIN at the recipe's structure) and the sparse GCN/GAT/GIN layers
on the card against the CPU, with no CSR kernel launched.  A test runs the
bench twin's ``csr`` runner (``pna_tpu_torch/bench.py``).  The last holds
the HIV config's simple layer on a 100,000-edge power-law graph and the
segment form of the bank on its receiver-hub twin card against CPU, with
no ``index_put`` kernel (``x[index]``'s backward) in a profiled step.  The
row-sum tests hold the kernel of ``ops/rowsum.py`` against its plain
version at chip_smoke.py's shapes, five launches bit-equal to each other
and to the plain version's order on the CPU, a gradient through
``gather_rows`` and ``segment_sum`` bit-equal in two runs, and a
large-graph trainer resume on the card equal to the straight run bit for
bit.  Every launch count held includes the row sum's (``_launches``)."""

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


def _launches(k1=0, k2=0, k3=0, k4=0, rows=0):
    """The launch counts of K1-K4 and the row sum, as
    ``fk.launch_counts`` gives them."""
    return {'csr_moment_sketch': k1, 'csr_dmsg': k2,
            'csr_pretrans_sketch': k3, 'csr_pretrans_dmsg': k4,
            'sorted_row_sum': rows}


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


# ---- the sparse bank's routing on the card ----------------------------

def _sparse_batch(seed=21, n_graphs=6, f=10, fe=4):
    """Random small graphs; graph 0's last node is isolated (in-degree 0, a
    salt's counter-ion in OGB molecules) and node 1 of each graph receives
    three edges carrying one message (equal sender features: max and min
    tie, and the variance E[x^2] - E[x]^2 rounds to a tiny value of either
    sign)."""
    from pna_tpu_torch.graph import batch_graphs
    rng = np.random.RandomState(seed)
    recs = []
    for g in range(n_graphs):
        n = rng.randint(6, 11)
        snd, rcv = [], []
        for v in range(2, n - (g == 0)):
            u = rng.randint(0, v)
            snd += [u, v]
            rcv += [v, u]
        snd += [0, 0, 0]
        rcv += [1, 1, 1]
        recs.append(dict(node_feats=rng.randn(n, f).astype(np.float32),
                         senders=np.asarray(snd, np.int32),
                         receivers=np.asarray(rcv, np.int32),
                         edge_feats=rng.randn(len(snd), fe).astype(
                             np.float32)))
    graph = batch_graphs(recs, with_snorm=True)
    iso = recs[0]['node_feats'].shape[0] - 1
    assert float(graph.in_degrees()[iso]) == 0 and bool(graph.node_mask[iso])
    return graph, iso


def _run_layer(make, graph, x, device):
    torch.manual_seed(0)
    m = make(device)
    m.load_state_dict(make('cpu').state_dict())
    m.train()
    g = graph.to(device)
    h = x.to(device).detach().requires_grad_(True)
    out = m(g, h, g.edge_feats)
    (torch.sin(out) * g.node_mask[:, None]).sum().backward()
    return (out.detach().cpu(), h.grad.cpu(),
            {k: p.grad.cpu() for k, p in m.named_parameters()})


def _hold_layer(make, graph, x, k1_calls):
    """The layer on the card (K1/K2 for the kernels' aggregators, plain
    torch for the rest) against the same weights on the CPU (segment form):
    output rtol 1e-4, atol 1e-5; every gradient within 1e-4 of the largest
    gradient entry (sums in other orders); one K1 and one K2 launch per
    bank."""
    before = fk.launch_counts()
    card = _run_layer(make, graph, x, 'cuda')
    torch.cuda.synchronize()
    after = fk.launch_counts()
    cpu = _run_layer(make, graph, x, 'cpu')
    assert after['csr_moment_sketch'] - before['csr_moment_sketch'] == k1_calls
    assert after['csr_dmsg'] - before['csr_dmsg'] == k1_calls
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-4, atol=1e-5)
    grads_card = dict(card[2], x=card[1])
    grads_cpu = dict(cpu[2], x=cpu[1])
    scale = max(float(g.abs().max()) for g in grads_cpu.values())
    for k, g in grads_cpu.items():
        assert torch.isfinite(grads_card[k]).all(), k
        assert float((grads_card[k] - g).abs().max()) <= 1e-4 * scale, k


@pytest.mark.cuda
@pytest.mark.parametrize("towers", [1, 5])
def test_cuda_sparse_layer_routes_kernels_and_plain(towers):
    """PNALayerSparse with edge features and identity and softmax beside
    mean/max/min/std: one K1/K2 call per tower on the card."""
    from pna_tpu_torch.nn.sparse import PNALayerSparse
    _need_card()
    graph, _ = _sparse_batch()
    aggs = ('mean', 'identity', 'max', 'softmax', 'min', 'std')

    def make(device):
        return PNALayerSparse(
            10, 10, aggs, ('identity', 'amplification', 'attenuation'),
            {'log': 1.3, 'lin': 2.1}, towers=towers, edge_features=True,
            edge_dim=4, graph_norm=True, batch_norm=True, residual=True,
            device=device, generator=torch.Generator().manual_seed(1))
    _hold_layer(make, graph, graph.node_feats, towers)


@pytest.mark.cuda
def test_cuda_pyg_conv_unclamped_var_and_towers():
    """PNAConvPyG (2 towers, divided input) with PyG's unclamped var: the
    towered messages go to K1 as one [E, T*F] call; node 1's equal messages
    give var_raw of either sign, unclamped on both devices."""
    from pna_tpu_torch.nn.pyg import PNAConvPyG
    _need_card()
    graph, _ = _sparse_batch(seed=22)

    def make(device):
        return PNAConvPyG(10, 8, ('mean', 'var', 'max', 'std', 'min'),
                          ('identity', 'amplification', 'linear'),
                          {'log': 1.3, 'lin': 2.1}, edge_dim=4, towers=2,
                          divide_input=True, pre_layers=2, post_layers=2,
                          device=device,
                          generator=torch.Generator().manual_seed(2))
    _hold_layer(make, graph, graph.node_feats, 1)


@pytest.mark.cuda
def test_cuda_bank_isolated_node():
    """The CSR bank on a batch with an isolated real node: K1's max and min
    are 0 there, as the segment reductions give, and the message gradient
    (K2, fields divided by the tie counts) is finite and equal to the
    CPU's."""
    from pna_tpu_torch.ops import segment as seg
    _need_card()
    graph, iso = _sparse_batch(seed=23)
    msg = torch.randn(graph.n_edge_pad, 7,
                      generator=torch.Generator().manual_seed(3))
    out = {}
    for dev in ('cpu', 'cuda'):
        g = graph.to(dev)
        layout = csr_bank.layout_from_graph(g)
        m = msg.to(dev).detach().requires_grad_(True)
        z = csr_bank.csr_raw_bank(m, layout, ('mean', 'max', 'min', 'std'))
        torch.sin(z).sum().backward()
        out[dev] = (z.detach().cpu(), m.grad.cpu())
    z, d = out['cuda']
    assert torch.equal(z[iso, 1], torch.zeros(7))
    assert torch.equal(z[iso, 2], torch.zeros(7))
    want_max = seg.segment_max(msg, graph.receivers, graph.n_node_pad,
                               graph.edge_mask)
    torch.testing.assert_close(z[:, 1], want_max)
    assert torch.isfinite(d).all()
    torch.testing.assert_close(z, out['cpu'][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d, out['cpu'][1], rtol=1e-4, atol=1e-5)


def _dense_batch(B=4, N=9, seed=30):
    """Symmetric random graphs without isolated nodes and their [B, N, 2]
    features (a one-hot source and a value, as the multitask data)."""
    rng = np.random.RandomState(seed)
    a = np.triu((rng.rand(B, N, N) < 0.4).astype(np.float32), 1)
    a = a + a.transpose(0, 2, 1)
    for b in range(B):
        for i in range(N):
            if a[b, i].sum() == 0:
                j = (i + 1) % N
                a[b, i, j] = a[b, j, i] = 1.0
    x = np.zeros((B, N, 2), np.float32)
    x[np.arange(B), rng.randint(0, N, B), 0] = 1.0
    x[..., 1] = rng.rand(B, N)
    return torch.tensor(x), torch.tensor(a)


def _dense_convs(layer):
    from pna_tpu_torch.nn import dense as td
    pna = dict(aggregators=('mean', 'max', 'min', 'std'),
               scalers=('identity', 'amplification', 'attenuation'),
               avg_d={'log': 1.3, 'lin': 2.1}, towers=4)
    cls, first, middle = {
        'pna': (td.PNALayerDense, dict(pna, divide_input=False),
                dict(pna, divide_input=True)),
        'mpnn': (td.PNALayerDense, dict(pna, aggregators=('sum',),
                                         scalers=('identity',),
                                         divide_input=False),
                 dict(pna, aggregators=('sum',), scalers=('identity',))),
        'gcn': (td.GCNLayerDense, {}, {}),
        'gat': (td.GATLayerDense, dict(nheads=4, alpha=0.2),
                dict(nheads=4, alpha=0.2)),
        'gin': (td.GINLayerDense, {}, {}),
    }[layer]
    return dict(first_conv=dict(layer_type=cls, args=first),
                middle_conv=dict(layer_type=cls, args=middle))


@pytest.mark.cuda
@pytest.mark.parametrize("layer", ['pna', 'mpnn', 'gcn', 'gat', 'gin'])
def test_cuda_dense_gnn_matches_cpu_and_launches_no_kernel(layer):
    """The multitask GNN at the recipe's structure (hidden 16, fixed
    variable N/2 depth, GRU, 3 readout layers) in training mode on the card
    against the same weights on the CPU: in float32 the outputs within rtol
    1e-4, atol 1e-5; in float64 every gradient within 1e-6 of the model's
    largest entry (float32 gradients part wherever a rounding moves a
    pre-activation across a ReLU's kink, see chip_smoke.py's MT_F32_TOL);
    the dense path launches none of K1 to K4."""
    from pna_tpu_torch.nn.gnn import GNN
    from pna_tpu_torch.train.losses import total_loss
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, adj = _dense_batch()
    kw = dict(in_features=2, nhid=16, nodes_out=3, graph_out=3,
              conv_layers='N/2', fixed=True, variable=True, gru=True,
              fc_layers=3, **_dense_convs(layer))
    rng = np.random.RandomState(31)
    target = (torch.tensor(rng.rand(4, 9, 3).astype(np.float32)),
              torch.tensor(rng.rand(4, 3).astype(np.float32)))
    state = GNN(**kw, device='cpu', seed=4).state_dict()
    res = {}
    fk.reset_launch_counts()
    for dev in ('cpu', 'cuda'):
        for dtype in (torch.float32, torch.float64):
            m = GNN(**kw, device=dev, seed=4)
            m.load_state_dict(state)
            m.to(dtype).train()
            out = m(x.to(dev, dtype), adj.to(dev, dtype))
            total_loss(out, tuple(t.to(dev, dtype) for t in target)
                       ).backward()
            res[dev, dtype] = ([o.detach().cpu() for o in out],
                               {k: p.grad.cpu()
                                for k, p in m.named_parameters()})
    torch.cuda.synchronize()
    assert set(fk.launch_counts().values()) == {0}
    for a, b in zip(res['cuda', torch.float32][0],
                    res['cpu', torch.float32][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    card, cpu = res['cuda', torch.float64][1], res['cpu', torch.float64][1]
    scale = max(float(g.abs().max()) for g in cpu.values())
    for k, g in cpu.items():
        assert torch.isfinite(card[k]).all(), k
        assert float((card[k] - g).abs().max()) <= 1e-6 * scale, k


@pytest.mark.cuda
@pytest.mark.parametrize("layer", ['gcn', 'gat', 'gin'])
def test_cuda_sparse_gcn_gat_gin_match_cpu(layer):
    """The edge-list GCN, GAT and GIN on the card (plain segment ops)
    against the CPU: float32 outputs rtol 1e-4, atol 1e-5, float64
    gradients within 1e-6 of the largest entry; no CSR kernel launches.
    The float32 step's sums of rows go through the row-sum kernel (float64
    keeps index_add_): GCN's message gather and sum (2), GAT's per head two
    logit gathers, the softmax's max gather, denominator and its gather,
    the message gather and the sum (14 for 2 heads), GIN's sum (1; its
    input needs no gradient)."""
    from pna_tpu_torch import graph as tgraph
    from pna_tpu_torch.nn import sparse as ts
    _need_card()
    x, adj = _dense_batch(seed=32)
    graph = tgraph.from_dense(adj.numpy(), x.numpy())
    make = {'gcn': lambda d: ts.GCNLayerSparse(2, 8, device=d),
            'gat': lambda d: ts.GATLayerSparse(2, 8, nheads=2, device=d),
            'gin': lambda d: ts.GINLayerSparse(2, 8, device=d)}[layer]
    res = {}
    fk.reset_launch_counts()
    for dev in ('cpu', 'cuda'):
        for dtype in (torch.float32, torch.float64):
            m = make(dev).to(dtype)
            g = graph.to(dev)
            h = g.node_feats.to(dtype)
            out = m(g, h)
            (torch.sin(out) * g.node_mask[:, None]).sum().backward()
            res[dev, dtype] = (out.detach().cpu(),
                               {k: p.grad.cpu()
                                for k, p in m.named_parameters()})
    torch.cuda.synchronize()
    rows = {'gcn': 2, 'gat': 14, 'gin': 1}[layer]
    assert fk.launch_counts() == _launches(rows=rows)
    torch.testing.assert_close(res['cuda', torch.float32][0],
                               res['cpu', torch.float32][0], rtol=1e-4,
                               atol=1e-5)
    card, cpu = res['cuda', torch.float64][1], res['cpu', torch.float64][1]
    scale = max(float(g.abs().max()) for g in cpu.values())
    for k, g in cpu.items():
        assert float((card[k] - g).abs().max()) <= 1e-6 * scale, k


# ---------------------------------------------------------------------------
# the layouts: bucketed, ELL and generic backends, remat (no JAX here)
# ---------------------------------------------------------------------------

LAYOUT_NET = dict(num_atom_type=28, num_bond_type=4, hidden_dim=16,
                  out_dim=16, n_layers=2, towers=2, edge_feat=True,
                  edge_dim=4, aggregators=('mean', 'max', 'min', 'std'),
                  scalers=('identity', 'amplification', 'attenuation'))


def _zinc_net(ds, device, **kw):
    from pna_tpu_torch.nn.nets import PNANetMolecules
    return PNANetMolecules(**dict(LAYOUT_NET, **kw), avg_d=ds.avg_d(),
                           device=device, seed=3)


def _hold_grads(card, cpu, tol, norm=False):
    """Every gradient of ``card`` within ``tol`` of ``cpu``'s: of its norm
    (bfloat16), or of its largest entry, at least 1e-3 of the model's
    largest (chip_smoke.py's ZERO_GRAD_FLOOR)."""
    floor = 1e-3 * max(float(p.grad.abs().max()) for p in cpu.parameters())
    for (k, a), b in zip(card.named_parameters(), cpu.parameters()):
        a, b = a.grad.cpu(), b.grad.cpu()
        assert torch.isfinite(a).all(), k
        if norm:
            err = float((a - b).norm() / max(float(b.norm()), 1e-30))
        else:
            err = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   floor)
        assert err <= tol, (k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,layout,bf16", [
    ('auto', 'bucketed', False), ('auto', 'bucketed', True),
    ('ell', 'ell', False), ('generic', 'csr', False)])
def test_cuda_layout_step_matches_cpu(kernel, layout, bf16):
    """One training step of a small ZINC net on the card against the same
    weights on the CPU, per backend: loss rtol 1e-4 (bfloat16 1e-2), every
    gradient within 2e-3 of its scale (bfloat16 5e-2 of its norm); the
    bucketed and ELL steps launch none of K1 to K4, the generic step (with
    identity, on a CSR batch) one K1 and one K2 per layer through the
    sparse bank; the row sum per layer: the sender gather on bucketed (its
    receiver side is a broadcast), both gathers on ELL, both and the
    in-degree count of identity's segment form on generic; one for the
    readout and two for the atom and bond lookups."""
    from pna_tpu_torch.data.molecules import ZincDataset, collate_records
    from pna_tpu_torch.train.step import loss_and_grads
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = ZincDataset.synthetic(n_train=24, n_val=1, n_test=1, seed=2)
    kw = {'bucketed': dict(bucket_by_degree=True),
          'ell': dict(with_ell=True), 'csr': {}}[layout]
    graph, labels = collate_records(ds.train, **kw)
    net_kw = dict(kernel=kernel,
                  compute_dtype=torch.bfloat16 if bf16 else None)
    if kernel == 'generic':
        net_kw['aggregators'] = LAYOUT_NET['aggregators'] + ('identity',)
    cpu = _zinc_net(ds, 'cpu', **net_kw)
    card = _zinc_net(ds, 'cuda', **net_kw)
    card.load_state_dict(cpu.state_dict())
    fk.reset_launch_counts()
    l_card = float(loss_and_grads(card, graph.to('cuda'), labels.cuda()))
    torch.cuda.synchronize()
    counts = fk.launch_counts()
    l_cpu = float(loss_and_grads(cpu, graph, labels))
    assert abs(l_card - l_cpu) <= (1e-2 if bf16 else 1e-4) * abs(l_cpu)
    _hold_grads(card, cpu, 5e-2 if bf16 else 2e-3, norm=bf16)
    L = LAYOUT_NET['n_layers']
    n = L if kernel == 'generic' else 0
    per_layer = {'bucketed': 1, 'ell': 2, 'csr': 3}[layout]
    assert counts == _launches(n, n, rows=per_layer * L + 1 + 2)


@pytest.mark.cuda
def test_cuda_remat_step_matches_plain_step():
    """remat=True against remat=False on the card, 'csr', dropout 0.1, the
    same weights and generator seed: loss rtol 1e-5, gradients within 2e-3
    of their scale, batch-norm statistics rtol 1e-6; K1 launches twice per
    layer (the recompute), K2 once."""
    from pna_tpu_torch.data.molecules import ZincDataset, collate_records
    from pna_tpu_torch.train.step import loss_and_grads
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = ZincDataset.synthetic(n_train=24, n_val=1, n_test=1, seed=2)
    g, y = collate_records(ds.train)
    g, y = g.to('cuda'), y.cuda()
    nets, losses, counts = [], [], []
    state = _zinc_net(ds, 'cpu').state_dict()
    for remat in (False, True):
        m = _zinc_net(ds, 'cuda', dropout=0.1, remat=remat)
        m.load_state_dict(state)
        fk.reset_launch_counts()
        losses.append(float(loss_and_grads(m, g, y)))
        torch.cuda.synchronize()
        counts.append(fk.launch_counts())
        nets.append(m)
    L = LAYOUT_NET['n_layers']
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    _hold_grads(nets[1], nets[0], 2e-3)
    for (k, a), b in zip(nets[1].state_dict().items(),
                         nets[0].state_dict().values()):
        if 'running' in k:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    assert counts[0]['csr_moment_sketch'] == counts[0]['csr_dmsg'] == L
    assert counts[1]['csr_moment_sketch'] == 2 * L
    assert counts[1]['csr_dmsg'] == L


@pytest.mark.cuda
def test_cuda_bucketed_trainer_launches_no_kernel():
    """PipelineConfig(bucket_by_degree=True) with kernel='auto' on the card:
    two epochs, every batch bucketed at the caps fit derives, finite falling
    loss, none of K1 to K4 launched; the row sum per train step once a
    layer (the sender gather), once for the readout and twice for the atom
    and bond lookups, and once per evaluation batch (the readout)."""
    from pna_tpu_torch.data.molecules import ZincDataset
    from pna_tpu_torch.nn.nets import PNANetMolecules
    from pna_tpu_torch.train.realworld import PipelineConfig, RealworldTrainer
    _need_card()
    ds = ZincDataset.synthetic(n_train=48, n_val=16, n_test=16, seed=2)
    trainer = RealworldTrainer(
        _zinc_net(ds, 'cuda', kernel='auto'), PNANetMolecules.loss,
        PipelineConfig(bucket_by_degree=True, epochs=2, batch_size=16,
                       init_lr=5e-3),
        forward_args=lambda g: (g, g.node_feats.squeeze(-1),
                                g.edge_feats.squeeze(-1)), device='cuda')
    fk.reset_launch_counts()
    _, _, hist = trainer.fit(ds, log_fn=lambda s: None)
    torch.cuda.synchronize()
    steps = sum(h['train_steps'] for h in hist)
    evals = 2 * (-(-len(ds.val) // 16) + -(-len(ds.test) // 16))
    assert fk.launch_counts() == _launches(
        rows=(LAYOUT_NET['n_layers'] + 1 + 2) * steps + evals)
    assert trainer.bucket_caps is not None
    losses = [h['train_loss'] for h in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.cuda
def test_cuda_hiv_ell_step_matches_cpu():
    """PNANetHIV on an ELL batch (the bank's ELL path) on the card against
    the CPU and against the CSR batch on the card; no K1 to K4 launch."""
    from pna_tpu_torch.data.hiv import HIVDataset
    from pna_tpu_torch.data.molecules import collate_records
    from pna_tpu_torch.nn.nets import PNANetHIV
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = HIVDataset.synthetic(n_train=24, n_val=1, n_test=1, seed=2)
    ell, y = collate_records(ds.train, with_ell=True)
    csr, _ = collate_records(ds.train)
    kw = dict(hidden_dim=16, out_dim=16, n_layers=2,
              aggregators=LAYOUT_NET['aggregators'],
              scalers=LAYOUT_NET['scalers'], avg_d=ds.avg_d(), seed=3)
    state = PNANetHIV(**kw, device='cpu').state_dict()
    models, losses = {}, {}
    for where, graph, dev in (('cpu', ell, 'cpu'), ('card', ell, 'cuda'),
                              ('csr', csr, 'cuda')):
        m = PNANetHIV(**kw, device=dev)
        m.load_state_dict(state)
        m.train()
        g = graph.to(dev)
        fk.reset_launch_counts()
        loss = PNANetHIV.loss(m(g, g.node_feats), y.to(dev), g.graph_mask)
        loss.backward()
        if where == 'card':
            torch.cuda.synchronize()
            # the sender gather and the ELL table's gather a layer, the
            # mean readout's sum and count, the AtomEncoder's 9 lookups
            assert fk.launch_counts() == _launches(rows=2 * 2 + 2 + 9)
        models[where], losses[where] = m, float(loss.detach())
    assert abs(losses['card'] - losses['cpu']) <= 1e-4 * abs(losses['cpu'])
    assert abs(losses['card'] - losses['csr']) <= 1e-4 * abs(losses['csr'])
    _hold_grads(models['card'], models['cpu'], 2e-3)


@pytest.fixture
def nccl_one_rank():
    """A 1-rank NCCL group in this process (no environment: an in-memory
    store), left again after the test."""
    from pna_tpu_torch.parallel import multihost
    _need_card()
    multihost.initialize(backend='nccl')
    yield
    multihost.shutdown()


@pytest.mark.cuda
def test_cuda_nccl_halo_exchange_one_rank(nccl_one_rank):
    """halo_exchange over the 1-rank NCCL group is the local gather, waited
    for at once and in flight; its backward is the gather's."""
    import torch.distributed as dist
    from pna_tpu_torch.parallel.partition import halo_exchange
    assert dist.get_backend() == 'nccl'
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(300, 16, generator=gen).cuda().requires_grad_(True)
    idx = torch.randint(0, 300, (1, 40), generator=gen,
                        dtype=torch.int32).cuda()
    mask = (torch.rand(1, 40, generator=gen) < 0.6).cuda()
    want = x[idx.reshape(-1).long()] * mask.reshape(-1, 1).float()
    got = halo_exchange(x, idx, mask)
    assert torch.equal(got, want)
    assert torch.equal(halo_exchange(x, idx, mask, wait=False).wait(), want)
    w = torch.randn(40, 16, generator=gen).cuda()
    g1, = torch.autograd.grad((got * w).sum(), x)
    g2, = torch.autograd.grad((want * w).sum(), x)
    assert torch.allclose(g1, g2, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ['csr', 'csr_fused', 'generic'])
def test_cuda_distributed_step_matches_cpu(nccl_one_rank, kernel):
    """The large-graph trainer's step (``make_node_train_step``, SGD 1e-2)
    on the card over the 1-rank NCCL mesh (a small hub-skewed graph with
    edge features, sorted partition) against the same step on the CPU
    without groups, from the same weights: the loss within 1e-4, every
    gradient within 2e-3 of its scale, every updated weight within 1e-2 x
    2e-3 of that scale (plus two float32 roundings); K1/K2 or K3/K4 once
    per layer (generic on a sorted part: the sparse bank's K1/K2)."""
    import torch.distributed as dist
    from pna_tpu_torch.parallel import multihost
    from pna_tpu_torch.parallel.distributed_net import (DistributedPNANet,
                                                        mesh_groups)
    from pna_tpu_torch.parallel.partition import (partition_edges,
                                                  powerlaw_graph,
                                                  sort_partition_edges)
    from pna_tpu_torch.train.largegraph import make_node_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    n, e, lr = 400, 3200, 1e-2
    send, recv = powerlaw_graph(n, e, seed=1, exponent=2.0)
    recv[:e // 5] = 0
    part = sort_partition_edges(partition_edges(send, recv, n, 1))
    rng = np.random.RandomState(2)
    ef = part.scatter_edge_features(rng.randn(e, 3).astype(np.float32))
    x = part.scatter_features(rng.randn(n, 6).astype(np.float32))
    y = rng.randn(*part.node_mask.shape).astype(np.float32)
    mesh = multihost.hybrid_mesh({'data': 1}, {'graph': 1},
                                 device_type='cuda')
    _, graph_group, _ = mesh_groups(mesh)
    kw = dict(feat_dim=6, hidden_dim=16, out_dim=16, n_layers=2, towers=2,
              node_level=True, edge_features=True, edge_dim=3,
              kernel=kernel, seed=0)
    nets = {'card': DistributedPNANet(graph_group=graph_group,
                                      bn_group=dist.group.WORLD,
                                      device='cuda', **kw),
            'cpu': DistributedPNANet(device='cpu', **kw)}
    losses = {}
    for where, net in nets.items():
        d, m = ('cuda', mesh) if where == 'card' else ('cpu', None)
        step, _, _ = make_node_train_step(
            part, m, net, torch.optim.SGD(net.parameters(), lr=lr),
            efeats=ef)
        xs, ys, ms = (torch.from_numpy(a[0]).to(d)
                      for a in (x, y, part.node_mask))
        fk.reset_launch_counts()
        losses[where] = step(xs, ys, ms)
        if where == 'card':
            counts = fk.launch_counts()
    assert abs(losses['card'] - losses['cpu']) <= 1e-4 * abs(losses['cpu'])
    _hold_grads(nets['card'], nets['cpu'], 2e-3)
    floor = 1e-3 * max(float(p.grad.abs().max())
                       for p in nets['cpu'].parameters())
    eps = torch.finfo(torch.float32).eps
    for a, b in zip(nets['card'].parameters(), nets['cpu'].parameters()):
        bound = (lr * 2e-3 * max(float(b.grad.abs().max()), floor)
                 + 2 * eps * float(b.detach().abs().max()))
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= bound
    want = {'csr': ('csr_moment_sketch', 'csr_dmsg'),
            'csr_fused': ('csr_pretrans_sketch', 'csr_pretrans_dmsg'),
            'generic': ('csr_moment_sketch', 'csr_dmsg')}[kernel]
    # the row sum: both gathers' backward a layer (csr_fused: d_u) and the
    # halo exchange's send gather
    rows = 2 + 2 if kernel == 'csr_fused' else 4 + 2
    assert counts == {k: 2 if k in want else rows if k == 'sorted_row_sum'
                      else 0 for k in counts}


@pytest.mark.cuda
def test_cuda_bench_runner_csr():
    """The bench twin's csr float32 runner (flat Adam) on the card at the
    flagship batch: three timed blocks, then its report: finite times and
    rates, a device time and busy share from the profile, 4 K1 and 4 K2
    launches per step and none of K3/K4, an MFU where the card is in the
    twin's table of peaks."""
    import math
    from pna_tpu_torch import bench
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    r = bench.BenchRunner(1024, True, None, 'csr', flat_opt=True,
                          device='cuda')
    r.warmup(3)
    for _ in range(3):
        r.time_block(5)
    rep = r.report()
    assert r.backends() == ['csr'] * 4
    # the row sum: 2 gathers' backward a layer, the readout, the atom and
    # bond lookups
    assert rep['launches_per_step'] == _launches(4, 4, rows=11)
    for key in ('step_ms', 'edges_per_sec', 'spread_ms',
                'matmul_tflops_per_step', 'device_ms_per_step', 'busy',
                'kernels_per_step'):
        assert math.isfinite(rep[key]) and rep[key] >= 0, key
    assert rep['edges_per_sec'] == pytest.approx(
        r.n_edges * 4 / (rep['step_ms'] / 1e3), rel=1e-9)
    assert 0 < rep['busy'] <= 1.5    # profiled steps run slower than timed
    if torch.cuda.get_device_name(0) in bench.PEAK_FLOPS:
        assert 0 < rep['mfu'] < 1


# ---------------------------------------------------------------------------
# the sparse path's gathers on a power-law graph (index_select, not x[index])
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ['hiv_simple', 'segment_bank'])
def test_cuda_powerlaw_gathers_match_cpu_without_index_put(case):
    """chip_smoke.py's sparse_powerlaw phase on its 100,000-edge check graph:
    the HIV config's simple layer on the power-law graph (sender gathers of
    a 38,000-edge hub) and the segment form's softmax, softmin and moment3
    on its receiver-hub twin (receiver gathers of a 20,000-edge hub).  Card
    against CPU at phase 4's limits (``sp_hold``: loss rtol 1e-4, every
    gradient within 2e-3 of its scale), exact K1/K2 launches and no
    index_put-family kernel or host op (x[index]'s backward) in a profiled
    card step (``sp_time`` raises otherwise)."""
    import chip_smoke as cs
    from pna_tpu_torch.train.largegraph import LargeGraphConfig
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    name, kind, width, k, rows, make = next(c for c in cs.sp_cases()
                                            if c[0] == case)
    graph, avg_d = cs.sp_graphs(cs.SP_CHECK_NODES, cs.SP_CHECK_EDGES,
                                LargeGraphConfig())[kind]
    model, _, worst = cs.sp_hold(name, make, width, graph, avg_d, 'cuda')
    assert worst <= cs.GRAD_TOL
    r, counts = cs.sp_time(name, model, width, k, rows, graph, 'cuda')
    assert r['device_ms'] > 0, "the profile recorded no device time"
    assert r['index_put_kernels'] == 0
    steps = cs.SP_WARM + cs.SP_TIMED
    assert counts == _launches(k * steps, k * steps, rows=rows * steps)
    assert r['index_add_kernels'] == 0


# ---------------------------------------------------------------------------
# the row sum (ops/rowsum.py): every float scatter-add on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_row_sum_matches_plain_at_the_path_shapes():
    """chip_smoke.py's row-sum phase: the kernel against its plain version
    (within SUM_RTOL of the summed magnitudes, plus one bfloat16 rounding
    for a bfloat16 output) and against index_add_ in float64, two launches
    bit-equal, at the flagship senders and sorted receivers (perm None),
    the atom and bond lookups, the readout, bfloat16 in and out, F = 1,
    400, 500, every other row empty, the large-graph senders (a
    383,653-edge sender) at F = 64 and 70 and the 200,007-edge receiver hub
    (sorted); the nine shapes of ops/timing.py::row_sum_cases timed."""
    import chip_smoke as cs
    from pna_tpu_torch.data.molecules import ZincDataset, collate_records
    from pna_tpu_torch.ops.timing import flush_buffer
    _need_card()
    ds = ZincDataset.synthetic(n_train=1024, n_val=1, n_test=1, seed=0)
    graph, _ = collate_records(ds.train, with_snorm=True)
    res = cs.rowsum_phase(graph, torch.device('cuda'),
                          flush_buffer(torch.device('cuda')))
    assert len(res['cases']) == 14
    assert res['cases']['largegraph senders']['max_rows_per_node'] == 383_653
    assert res['cases']['receiver hub, sorted']['max_rows_per_node'] \
        == 200_007
    assert res['cases']['every other row empty']['empty_nodes'] \
        >= graph.n_node_pad
    timed = [r for r in res['cases'].values() if 'ms' in r]
    assert len(timed) == 9
    for key in ('ms', 'clean_ms', 'plain_ms', 'library_ms', 'sort_ms',
                'hub_ms', 'receiver_hub_ms'):
        assert res[key] > 0, key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_row_sum_same_bits_every_run(dtype):
    """A hub of a third of 300,000 rows over many tiles, F = 1 (32 rows a
    warp), 64 (16-byte rows, 2 a warp) and 70: five launches with the
    layout's keys give the same bits, and so does the plain version's order
    on the CPU (index_add_ adds in index order there)."""
    from pna_tpu_torch.ops import rowsum
    _need_card()
    rng = np.random.RandomState(5)
    for f in (1, 64, 70):
        idx = rng.randint(0, 5000, 300_000)
        idx[rng.rand(300_000) < 1 / 3] = 17
        src = torch.from_numpy(rng.randn(300_000, f).astype(np.float32))
        src = src.to(dtype)
        lay = rowsum.index_layout(torch.from_numpy(idx).cuda(), 5000)
        runs = [rowsum.sorted_row_sum(src.cuda(), lay.perm, lay.ptr,
                                      lay.keys) for _ in range(5)]
        torch.cuda.synchronize()
        assert all(torch.equal(runs[0], r) for r in runs[1:])
        cpu = rowsum.sorted_row_sum_plain(src, lay.perm.cpu(), lay.ptr.cpu())
        assert torch.equal(runs[0].cpu(), cpu)


@pytest.mark.cuda
def test_cuda_gather_and_segment_sum_grads_same_bits():
    """The gradient through gather_rows (a power-law sender) and
    segment_sum (a receiver hub) on the card is the same in two runs, each
    launching the row sum twice (the gather's backward, the sum's
    forward)."""
    from pna_tpu_torch.ops import segment as seg
    _need_card()
    rng = np.random.RandomState(6)
    n, e, f = 4000, 200_000, 70
    snd = rng.randint(0, n, e)
    snd[rng.rand(e) < 0.4] = 3
    rcv = rng.randint(0, n, e)
    rcv[rng.rand(e) < 0.2] = 0
    snd, rcv = (torch.from_numpy(a).cuda() for a in (snd, rcv))
    x0 = torch.from_numpy(rng.randn(n, f).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.randn(n, f).astype(np.float32)).cuda()
    grads = []
    for _ in range(2):
        x = x0.clone().requires_grad_(True)
        fk.reset_launch_counts()
        out = seg.segment_sum(torch.sin(seg.gather_rows(x, snd)), rcv, n)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        assert fk.launch_counts() == _launches(rows=2)
        grads.append((out.detach(), x.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    # against float64, within 1e-5 of the summed magnitudes (SUM_RTOL)
    terms = (torch.cos(x0.cpu().double()[snd.cpu()])
             * w.cpu().double()[rcv.cpu()])
    want, scale = (torch.zeros(n, f, dtype=torch.float64).index_add_(
        0, snd.cpu(), t) for t in (terms, terms.abs()))
    err = (grads[0][1].cpu().double() - want).abs()
    assert bool((err <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
def test_cuda_largegraph_trainer_resume_exact(nccl_one_rank, tmp_path):
    """The card's twin of tests/test_torch_largegraph.py's
    test_trainer_resume_exact: on the csr backend, 3 steps, a checkpoint and
    3 resumed steps give the losses and weights of 6 straight steps, bit
    for bit (torch.equal on every weight)."""
    import os
    from pna_tpu_torch.train.largegraph import (LargeGraphConfig,
                                                train_largegraph)

    def run(**kw):
        base = dict(num_nodes=2000, num_edges=10000, d_graph=1,
                    hidden_dim=16, out_dim=16, towers=2, n_layers=2,
                    steps=6, eval_every=100, ckpt_every=3, kernel='csr',
                    lr=3e-3, seed=0)
        base.update(kw)
        return train_largegraph(LargeGraphConfig(**base), device='cuda')

    net_c, hist_c = run()
    d = str(tmp_path / 'ck')
    _, h1 = run(steps=3, ckpt_dir=d)
    assert os.path.exists(os.path.join(d, 'latest.ckpt'))
    net_r, h2 = run(ckpt_dir=d, resume=True)
    assert [h['step'] for h in h2] == [4, 5, 6]
    assert [h['train_loss'] for h in h1 + h2] == [
        h['train_loss'] for h in hist_c]
    for k, v in net_c.state_dict().items():
        assert torch.equal(net_r.state_dict()[k], v), k
