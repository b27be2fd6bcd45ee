"""The port's deterministic scatter-add (``ops/rowsum.py``) on the CPU, held
against ``pna_tpu``.

* ``sorted_row_sum_plain`` (the kernel's order of addition in torch) against
  ``jax.ops.segment_sum`` on a power-law index with a hub of a third of the
  rows, empty rows, an unsorted index, ``perm`` None on a sorted one, widths
  1, 64, 70 and 500, and hubs that span many tiles and merge runs.  Float32,
  within 1e-5 of the summed magnitudes (``chip_smoke.py``'s SUM_RTOL: the
  two sum in other orders).
* ``index_layout`` against numpy's stable argsort and searchsorted, exactly.
* ``gather_rows``' backward against ``jax.grad`` of ``x[idx]``, and
  ``segment_sum``'s forward and backward against JAX's, on the CPU's path
  (``index_add_``) and on the card's, which these tests take on the CPU by
  routing every float32/bfloat16 sum through the row sum
  (``_card_route``): the wrapper then runs its plain version.  On that
  route the sparse and segment cases of tests/test_torch_gathers.py, the
  flagship net on ``csr`` and ``csr_fused`` (tests/test_torch_net.py, also
  bfloat16) and the large-graph trainer's exact resume
  (tests/test_torch_largegraph.py) hold at those files' tolerances.
* The routing: on the CPU, ``gather_rows``' backward and ``segment_sum`` never
  call the row sum, the CSR kernels' plain versions never do on either route,
  and the wrapper takes its plain version for a CPU tensor and counts no
  launch.
"""

import ast

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu_torch.ops import csr_fused_kernels as fk
from pna_tpu_torch.ops import csr_kernels as ck
from pna_tpu_torch.ops import rowsum
from pna_tpu_torch.ops import segment as seg

SUM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Sums of the CPU's index_add_ in one fixed order, beside other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _hold_keys(keys, ptr, e):
    """The kernel's contract on keys: each sorted position in [ptr[0],
    ptr[n]) holds its row (the one whose row pointers bracket it)."""
    lo = ptr.long().clamp(0, e)
    pos = torch.arange(e)
    node = torch.searchsorted(lo, pos, right=True) - 1
    inside = (pos >= lo[0]) & (pos < lo[-1])
    assert torch.equal(keys.long()[inside], node[inside])


@pytest.fixture
def card_route(monkeypatch):
    """Every float32/bfloat16 sum of rows takes the card's route (the
    autograd functions over the row sum) on the CPU too; returns the list of
    the row sums' (rows, features) shapes.  Every call must pass keys that
    keep the kernel's contract (``_hold_keys``)."""
    calls = []
    wrapper = rowsum.sorted_row_sum

    def counted(src, perm, ptr, keys, out_dtype=None):
        calls.append(tuple(src.shape))
        _hold_keys(keys, ptr, src.shape[0])
        return wrapper(src, perm, ptr, keys, out_dtype)

    monkeypatch.setattr(seg, '_on_kernel',
                        lambda x: x.dtype in seg._ROW_SUM_DTYPES)
    monkeypatch.setattr(rowsum, 'sorted_row_sum', counted)
    return calls


def _index(case, rng, e, n):
    """An index of ``e`` rows into ``n`` for one case."""
    if case == 'hub_third':           # a sender owning a third of the rows
        idx = np.minimum((rng.pareto(1.5, e) * 3).astype(np.int64), n - 1)
        idx[rng.rand(e) < 1 / 3] = 5
    elif case == 'empty_rows':        # only every third row receives
        idx = rng.randint(0, n // 3, e) * 3
    elif case == 'unsorted':
        idx = rng.randint(0, n, e)
    elif case == 'sorted':
        idx = np.sort(rng.randint(0, n, e))
    elif case == 'many_tiles':        # a hub over 40 tiles: merge runs of 2
        idx = rng.randint(0, n, e)
        idx[:40 * rowsum.TILE + 17] = 2
        rng.shuffle(idx)
    else:
        raise ValueError(case)
    return idx


def _hold_sum(got, idx, src, n):
    """Against jax.ops.segment_sum within SUM_RTOL of the summed
    magnitudes."""
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(src), jnp.asarray(idx),
                                          num_segments=n))
    scale = np.asarray(jax.ops.segment_sum(jnp.abs(jnp.asarray(src)),
                                           jnp.asarray(idx),
                                           num_segments=n))
    err = np.abs(np.asarray(got, np.float64) - want)
    assert np.all(err <= SUM_RTOL * scale + 1e-6), float(err.max())


CASES = ['hub_third', 'empty_rows', 'unsorted', 'sorted', 'many_tiles']


@pytest.mark.parametrize("f", [1, 64, 70, 500])
@pytest.mark.parametrize("case", CASES)
def test_plain_row_sum_matches_jax_segment_sum(case, f):
    rng = np.random.RandomState(CASES.index(case) * 1000 + f)
    e, n = (12_000 if case == 'many_tiles' else 3_000), 400
    if f == 500 and case == 'many_tiles':
        e = 11_000
    idx = _index(case, rng, e, n)
    src = (rng.randn(e, f) * np.exp(rng.randn(e, 1))).astype(np.float32)
    lay = rowsum.index_layout(torch.from_numpy(idx), n)
    perm = None if case == 'sorted' else lay.perm
    if case == 'sorted':
        assert torch.equal(lay.perm, torch.arange(e, dtype=torch.int32))
    got = rowsum.sorted_row_sum_plain(torch.from_numpy(src), perm, lay.ptr)
    assert got.shape == (n, f) and got.dtype == torch.float32
    _hold_sum(got, idx, src, n)
    if case == 'empty_rows':
        assert torch.all(got[1::3] == 0) and torch.all(got[2::3] == 0)


def test_plain_row_sum_is_the_kernels_order():
    """The plain version's roundings are the kernel's: at F = 3 a lane holds
    one feature and a warp 8 rows, so a lane group's strip is 4 sorted
    rows; a node inside one strip is their sum in order from 0, a node over
    strips of one chunk of 32 the strip pieces added in order (each from
    0), a node over chunks of one tile the chunk pieces added in order; a
    node over two tiles is its two tile pieces added; a node over 40 tiles
    is 32 runs of at most 2 tile pieces, added in order.  Checked against
    those sums written out in numpy float32."""
    rng = np.random.RandomState(3)
    run = rowsum.strip(3, 3)
    assert run == 4
    n_hub = 40 * rowsum.TILE + 17        # 41 tiles: runs of ceil(41/32) = 2
    idx = np.concatenate([[0] * 5, [1] * 300, [2] * n_hub, [3] * 3])
    src = rng.randn(len(idx), 3).astype(np.float32) * 1e3
    src[::7] *= 1e-4                     # cancellation: order shows
    lay = rowsum.index_layout(torch.from_numpy(idx), 4)
    got = rowsum.sorted_row_sum_plain(torch.from_numpy(src), None,
                                      lay.ptr).numpy()

    def seq(rows):
        acc = np.zeros(3, np.float32)
        for r in rows:
            acc = acc + r
        return acc

    def node(lo, hi):
        """Sum of rows [lo, hi) by the kernel's rule."""
        strip_sums, chunk_sums = {}, {}
        for c0 in range(lo // run * run, hi, run):
            a, b = max(lo, c0), min(hi, c0 + run)
            strip_sums.setdefault(a // rowsum.CHUNK, []).append(
                seq(src[a:b]))
        for c, p in sorted(strip_sums.items()):
            chunk_sums.setdefault(c * rowsum.CHUNK // rowsum.TILE,
                                  []).append(seq(p))
        tile_sums = [seq(p) for _, p in sorted(chunk_sums.items())]
        if len(tile_sums) == 1:
            return tile_sums[0]
        q = -(-len(tile_sums) // rowsum.MERGE_RUNS)
        return seq([seq(tile_sums[i:i + q])
                    for i in range(0, len(tile_sums), q)])

    ptr = lay.ptr.numpy()
    for k in range(4):
        np.testing.assert_array_equal(got[k], node(ptr[k], ptr[k + 1]))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_index_layout_matches_numpy_exactly(dtype):
    """perm is numpy's stable argsort, keys the sorted index (int32), ptr
    the left searchsorted of 0..n; ids outside [0, n) fall outside
    [ptr[0], ptr[n])."""
    rng = np.random.RandomState(1)
    idx = rng.randint(-3, 60, 5000)
    idx[:1000] = 17
    t = torch.from_numpy(idx).to(dtype)
    lay = rowsum.index_layout(t, 50)
    order = np.argsort(idx, kind='stable')
    assert lay.perm.dtype == torch.int32 and lay.ptr.dtype == torch.int32
    assert lay.keys.dtype == torch.int32
    np.testing.assert_array_equal(lay.perm.numpy(), order)
    np.testing.assert_array_equal(lay.keys.numpy(), np.sort(idx,
                                                            kind='stable'))
    np.testing.assert_array_equal(
        lay.ptr.numpy(), np.searchsorted(idx[order], np.arange(51)))
    assert int(lay.ptr[0]) == int((idx < 0).sum())
    assert int(lay.ptr[-1]) == int((idx < 50).sum())


def test_index_layout_is_kept_on_its_index():
    """The same tensor and row count give the kept layout, its keys
    included; another row count, another tensor or an in-place edit of the
    index a new one."""
    t = torch.tensor([3, 1, 1, 0, 2])
    a = rowsum.index_layout(t, 4)
    assert rowsum.index_layout(t, 4) is a
    assert rowsum.index_layout(t, 4).keys is a.keys
    assert any(lay.keys is a.keys
               for lay in t.__dict__['_pna_row_layouts'].values())
    np.testing.assert_array_equal(a.keys.numpy(), [0, 1, 1, 2, 3])
    assert rowsum.index_layout(t, 5) is not a
    assert rowsum.index_layout(t.clone(), 4) is not a
    t[0] = 0
    b = rowsum.index_layout(t, 4)
    assert b is not a
    np.testing.assert_array_equal(b.perm.numpy(), [0, 3, 1, 2, 4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_takes_its_plain_version_on_the_cpu(dtype):
    """For a CPU tensor the wrapper is its plain version (bfloat16 rounded
    once, or float32 out) and counts no launch."""
    rng = np.random.RandomState(2)
    idx = torch.from_numpy(rng.randint(0, 30, 700))
    src = torch.from_numpy(rng.randn(700, 9).astype(np.float32)).to(dtype)
    lay = rowsum.index_layout(idx, 30)
    before = rowsum.sorted_row_sum.launches
    for out in (dtype, torch.float32):
        got = rowsum.sorted_row_sum(src, lay.perm, lay.ptr, lay.keys, out)
        want = rowsum.sorted_row_sum_plain(src, lay.perm, lay.ptr, out)
        assert got.dtype == out and torch.equal(got, want)
    assert rowsum.sorted_row_sum.launches == before
    assert fk.launch_counts()['sorted_row_sum'] == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    src = torch.zeros(6, 3)
    lay = rowsum.index_layout(torch.tensor([0, 1, 1, 2, 0, 1]), 3)
    bad = [
        (src.double(), lay.perm, lay.ptr, None),        # float64
        (src[:, 0], lay.perm, lay.ptr, None),           # 1-D
        (src, lay.perm.long(), lay.ptr, None),          # int64 perm
        (src, lay.perm[:5], lay.ptr, None),             # perm's length
        (src, lay.perm, lay.ptr.long(), None),          # int64 ptr
        (src, lay.perm, lay.ptr, torch.bfloat16),       # f32 -> bf16
        (torch.zeros(3, 6).t(), lay.perm, lay.ptr, None),  # not contiguous
    ]
    for args in bad:
        with pytest.raises(ValueError):
            rowsum.sorted_row_sum(*args[:3], lay.keys, args[3])
    for keys in (lay.keys.short(), lay.keys[:5],        # int16, length
                 lay.keys.float(), torch.zeros(12, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError):
            rowsum.sorted_row_sum(src, lay.perm, lay.ptr, keys)


def test_wrapper_has_no_fallback():
    """For a CUDA tensor the wrapper launches its kernel or raises: no try
    (as tests/test_torch_isolation.py holds K1-K4)."""
    with open(rowsum.__file__) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == 'sorted_row_sum')
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))


def _jax_gather_sum(x, snd, rcv, n, w):
    """JAX's loss sum(segment_sum(sin(x[snd]), rcv) * w) and its gradient."""
    def lf(xx):
        out = jax.ops.segment_sum(jnp.sin(xx[jnp.asarray(snd)]),
                                  jnp.asarray(rcv), num_segments=n)
        return jnp.sum(out * w), out
    (_, out), g = jax.value_and_grad(lf, has_aux=True)(jnp.asarray(x))
    return np.asarray(out), np.asarray(g)


def _gather_sum_case(seed=4, n=300, e=4000, f=70):
    rng = np.random.RandomState(seed)
    snd = rng.randint(0, n, e)
    snd[rng.rand(e) < 0.4] = 3                 # a power-law sender's hub
    rcv = rng.randint(0, n, e)
    rcv[rng.rand(e) < 0.25] = 9
    x = rng.randn(n, f).astype(np.float32)
    w = rng.randn(n, f).astype(np.float32)
    return x, snd, rcv, n, w


@pytest.mark.parametrize("route", ['cpu', 'card'])
def test_gather_and_segment_sum_match_jax(route, request):
    """segment_sum(sin(gather_rows(x, senders)), receivers): the output and
    x's gradient against JAX's (x[idx], jax.ops.segment_sum, jax.grad),
    within 1e-5 of the summed magnitudes, on the CPU's route and on the
    card's (two row sums: the sum's forward and the gather's backward)."""
    calls = request.getfixturevalue('card_route') if route == 'card' else None
    x, snd, rcv, n, w = _gather_sum_case()
    out_j, g_j = _jax_gather_sum(x, snd, rcv, n, w)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = seg.segment_sum(torch.sin(seg.gather_rows(xt, torch.from_numpy(
        snd))), torch.from_numpy(rcv), n)
    (out * torch.from_numpy(w)).sum().backward()
    scale_out = np.asarray(jax.ops.segment_sum(
        jnp.abs(jnp.sin(jnp.asarray(x)[snd])), rcv, num_segments=n))
    assert np.all(np.abs(out.detach().numpy() - out_j)
                  <= SUM_RTOL * scale_out + 1e-6)
    scale_g = np.asarray(jax.ops.segment_sum(
        jnp.abs(jnp.cos(jnp.asarray(x)[snd]) * jnp.asarray(w)[rcv]), snd,
        num_segments=n))
    assert np.all(np.abs(xt.grad.numpy() - g_j) <= SUM_RTOL * scale_g + 1e-6)
    if calls is not None:
        assert calls == [(len(rcv), x.shape[1]), (len(snd), x.shape[1])]


def test_gather_rows_over_row_pointers_matches_jax(card_route):
    """gather_rows(x, receivers, edge_ptr) of a receiver-sorted index takes
    the row pointers as its layout (no sort): its backward against
    jax.grad of x[idx]; row pointers of another length raise."""
    rng = np.random.RandomState(8)
    n, e = 120, 2000
    rcv = np.sort(rng.randint(0, n, e))
    rcv[-300:] = n - 1                       # a hub at the tail
    ptr = torch.from_numpy(np.searchsorted(rcv, np.arange(n + 1)).astype(
        np.int32))
    x = rng.randn(n, 33).astype(np.float32)
    gw = rng.randn(e, 33).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    index = torch.from_numpy(rcv)
    (seg.gather_rows(xt, index, ptr) * torch.from_numpy(gw)).sum().backward()
    assert '_pna_row_layouts' not in index.__dict__    # no sort was made
    g_j = jax.grad(lambda xx: jnp.sum(xx[rcv] * gw))(jnp.asarray(x))
    scale = np.asarray(jax.ops.segment_sum(jnp.abs(jnp.asarray(gw)), rcv,
                                           num_segments=n))
    assert np.all(np.abs(xt.grad.numpy() - np.asarray(g_j))
                  <= SUM_RTOL * scale + 1e-6)
    with pytest.raises(ValueError, match="row pointers"):
        y = torch.from_numpy(x).requires_grad_(True)
        seg.gather_rows(y, index, ptr[:-1]).sum().backward()


def test_gather_rows_over_a_padded_part_keeps_the_padding_out(card_route):
    """A partition's part (``sort_partition_edges``): real edges sorted by
    receiver, padding with receiver 0 after them, row pointers over the
    real edges only.  The index is passed as the keys, and the padding's
    rows past ptr[n] add nothing: the gradient equals index_add_ over the
    real edges."""
    from pna_tpu_torch.parallel.partition import (partition_edges,
                                                  powerlaw_graph,
                                                  sort_partition_edges)
    snd, rcv = powerlaw_graph(300, 3000, seed=2, exponent=1.5)
    part = sort_partition_edges(partition_edges(snd, rcv, 300, 2))
    for p in range(part.num_parts):
        ptr = torch.from_numpy(part.edge_ptr[p])
        index = torch.from_numpy(part.receivers_local[p]).long()
        real = int(ptr[-1])
        assert real < index.numel() and bool((index[real:] == 0).all())
        n = ptr.numel() - 1
        gw = torch.from_numpy(np.random.RandomState(p).randn(
            index.numel(), 5).astype(np.float32))
        x = torch.zeros(n, 5, requires_grad=True)
        (seg.gather_rows(x, index, ptr) * gw).sum().backward()
        want = torch.zeros(n, 5).index_add_(0, index[:real], gw[:real])
        assert torch.allclose(x.grad, want, rtol=1e-5, atol=1e-5)


def test_bf16_gather_and_segment_sum_on_the_card_route(card_route):
    """In bfloat16 the card's route sums in float32 and rounds once: its
    output and gradient within one bfloat16 rounding (2^-8) of the float32
    route's, plus 1e-5 of the summed magnitudes."""
    x, snd, rcv, n, w = _gather_sum_case(seed=7, f=64)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
        out = seg.segment_sum(seg.gather_rows(xt, torch.from_numpy(snd)),
                              torch.from_numpy(rcv), n)
        (out.float() * torch.from_numpy(w)).sum().backward()
        assert out.dtype == dtype and xt.grad.dtype == dtype
        res[dtype] = (out.detach().float(), xt.grad.float())
    xb = torch.from_numpy(x).bfloat16().float()
    scale = torch.zeros(n, x.shape[1]).index_add_(
        0, torch.from_numpy(rcv), xb[torch.from_numpy(snd)].abs())
    want = torch.zeros(n, x.shape[1]).index_add_(
        0, torch.from_numpy(rcv), xb[torch.from_numpy(snd)])
    got = res[torch.bfloat16][0]
    assert torch.all((got - want).abs()
                     <= 2.0 ** -8 * want.abs() + SUM_RTOL * scale + 1e-6)
    wb = torch.from_numpy(w).bfloat16().float()
    g_want = torch.zeros(n, x.shape[1]).index_add_(
        0, torch.from_numpy(snd), wb[torch.from_numpy(rcv)])
    g_scale = torch.zeros(n, x.shape[1]).index_add_(
        0, torch.from_numpy(snd), wb[torch.from_numpy(rcv)].abs())
    assert torch.all((res[torch.bfloat16][1] - g_want).abs()
                     <= 2.0 ** -8 * g_want.abs() + SUM_RTOL * g_scale
                     + 1e-6)


def test_masked_segment_sum_and_count_on_the_card_route(card_route):
    """The masked form keeps its mask in front of the row sum; counts are
    exact; segment_mean's backward is a row gather."""
    rng = np.random.RandomState(9)
    data = rng.randn(500, 6).astype(np.float32)
    ids = rng.randint(0, 40, 500)
    mask = rng.rand(500) > 0.3
    d, i, m = (torch.from_numpy(a) for a in (data, ids, mask))
    dt = d.clone().requires_grad_(True)
    got = seg.segment_mean(dt, i, 40, m)
    got.sum().backward()
    want = np.asarray(jax.ops.segment_sum(
        jnp.where(jnp.asarray(mask)[:, None], data, 0.0), ids,
        num_segments=40))
    cnt = np.bincount(ids[mask], minlength=40).astype(np.float32)
    np.testing.assert_allclose(got.detach().numpy(),
                               want / np.maximum(cnt, 1)[:, None],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        seg.segment_count(i, 40, m).numpy(), cnt)
    grad = np.where(mask[:, None], 1.0 / np.maximum(cnt, 1)[ids][:, None],
                    0.0)
    np.testing.assert_allclose(dt.grad.numpy(), np.broadcast_to(
        grad, data.shape), rtol=1e-6)


def test_cpu_route_never_calls_the_row_sum(monkeypatch):
    """On the CPU, gather_rows' backward (index_select's own, index_add_)
    and segment_sum (index_add_) take the plain path: the row sum is never
    called, and the values are those of index_add_."""
    def refuse(*args, **kwargs):
        raise AssertionError("the row sum was called on the CPU route")

    monkeypatch.setattr(rowsum, 'sorted_row_sum', refuse)
    x, snd, rcv, n, w = _gather_sum_case(seed=5)
    xt = torch.from_numpy(x).requires_grad_(True)
    g = seg.gather_rows(xt, torch.from_numpy(snd))
    assert g.grad_fn.name() == 'IndexSelectBackward0'
    out = seg.segment_sum(g, torch.from_numpy(rcv), n)
    (out * torch.from_numpy(w)).sum().backward()
    want = torch.zeros(n, x.shape[1]).index_add_(
        0, torch.from_numpy(snd), torch.from_numpy(w)[torch.from_numpy(rcv)])
    assert torch.equal(xt.grad, want)


@pytest.mark.parametrize("route", ['cpu', 'card'])
def test_kernel_plain_versions_never_call_the_row_sum(route, monkeypatch,
                                                      request):
    """The plain versions of K1-K4 (and the segment merge) are built on
    segment_sum_plain, so that holding a kernel to them on the card
    launches no row sum."""
    if route == 'card':
        request.getfixturevalue('card_route')

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version called the row sum")

    monkeypatch.setattr(rowsum, 'sorted_row_sum', refuse)
    rng = np.random.RandomState(10)
    ptr = torch.tensor([0, 40, 40, 75, 100], dtype=torch.int32)
    msg = torch.from_numpy(rng.randn(100, 7).astype(np.float32))
    k6 = ck.csr_moment_sketch_plain(msg, ptr, True)
    fields = [torch.randn(4, 7) for _ in range(4)] + list(k6[2:4])
    ck.csr_dmsg_plain(msg, ptr, *fields)
    u, v = torch.randn(6, 7), torch.randn(4, 7)
    snd = torch.from_numpy(rng.randint(0, 6, 100).astype(np.int32))
    fk.csr_pretrans_sketch_plain(u, v, snd, ptr, with_ties=True)
    fk.csr_pretrans_dmsg_plain(u, v, snd, ptr, *fields)
    segs = ck.csr_segments(ptr)
    parts = ck.csr_moment_sketch_plain(msg, segs.seg_ptr, True)
    fk.merge_segment_sketches_plain(parts, segs)


# ---- the card's route on whole paths, against pna_tpu -------------------

GATHER_CASES = ['hiv_simple', 'zinc_towers', 'pyg_simple', 'pyg_towers',
                'gcn', 'gat', 'gin', 'segment_bank',
                'segment_softmax_weights', 'segment_moment']


@pytest.mark.parametrize("case", GATHER_CASES)
def test_sparse_cases_match_jax_on_the_card_route(case, card_route):
    """tests/test_torch_gathers.py's cases on its hub graph (a 200-edge
    sender and receiver) with every sum of rows through the row sum:
    values and gradients against JAX at that file's tolerances."""
    from tests.test_torch_gathers import test_hub_graph_matches_jax
    test_hub_graph_matches_jax(case)
    assert card_route, "the card's route took no row sum"


@pytest.mark.parametrize("kernel", ['csr', 'csr_fused'])
def test_flagship_net_matches_jax_on_the_card_route(kernel, card_route):
    """The flagship net (edge features, L = 2, narrowed) on the card's
    route against the JAX net: loss, every gradient, batch-norm statistics
    and the eval output at tests/test_torch_net.py's tolerances; the row
    sums are the step's (2 a layer on csr, 1 on csr_fused, the atom and
    bond lookups, the readout's in the step and in the eval forward)."""
    from tests.test_torch_net import _check_net
    _check_net(True, kernel)
    per_layer = 2 if kernel == 'csr' else 1
    assert len(card_route) == per_layer * 2 + 2 + 1 + 1


def test_flagship_net_bf16_matches_jax_on_the_card_route(card_route):
    """compute_dtype=bfloat16 on csr: tests/test_torch_net.py's bf16 check
    (loss rtol 1e-2, every gradient within 5e-2 of its norm) with the row
    sums in float32, rounded once."""
    from tests.test_torch_net import test_bf16_net_matches_jax_bf16
    test_bf16_net_matches_jax_bf16('csr')
    assert card_route


def test_largegraph_resume_exact_on_the_card_route(tmp_path, card_route):
    """The large-graph trainer on csr with the row sums: 3 steps, a
    checkpoint and 3 resumed steps equal 6 straight steps bit for bit."""
    from tests.test_torch_largegraph import test_trainer_resume_exact
    test_trainer_resume_exact(tmp_path)
    assert card_route
