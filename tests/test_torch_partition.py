"""The port's host-side partitioning, native library, labels, layout model
and partial statistics against pna_tpu.

* Every array of ``partition_edges`` (with ``reorder='locality'`` and with
  ``None``), ``sort_partition_edges``, ``split_edges``,
  ``_edge_origin_numpy``, ``powerlaw_graph``, ``neighbor_stats_labels`` and
  ``predict_layout_bytes``'s CSR and generic estimates (given the JAX
  package's work factor) equals the JAX package's, element for element.
  The JAX partition's degree-bucketed fields, a layout the port does not
  have, are None on every partition compared.
* The port's C++ library (``pna_tpu_torch/native``, built with g++ here)
  equals its numpy twins.
* ``ops/partial_stats.py`` against the JAX module within 1e-6 (sketches,
  combine, the finalised bank, and the bank's gradient).
* ``choose_layout``'s decision table under the port's constants.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pna_tpu.ops import layout as jlayout
from pna_tpu.ops import partial_stats as jps
from pna_tpu.parallel import partition as jpart
from pna_tpu.train.largegraph import neighbor_stats_labels as jlabels
from pna_tpu_torch import native
from pna_tpu_torch.ops import layout as tlayout
from pna_tpu_torch.ops import partial_stats as tps
from pna_tpu_torch.parallel import partition as tpart
from pna_tpu_torch.train.largegraph import neighbor_stats_labels as tlabels


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch's ops in this process run on one thread: beside other test
    workers and the spawned ranks, its thread pool would wait on threads the
    system has put to sleep."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

def _assert_parts_equal(a, b):
    """Every field of the JAX ``a`` equal in the port's ``b``; a field the
    port does not have is None in ``a``."""
    for f in dataclasses.fields(a):
        if not hasattr(b, f.name):
            assert getattr(a, f.name) is None, f.name
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, f.name
            assert x.dtype == y.dtype, (f.name, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, (f.name, x, y)


def _graph(n=64, e=400, seed=1):
    return jpart.powerlaw_graph(n, e, seed=seed)


@pytest.mark.parametrize("n,e,seed", [(64, 400, 1), (500, 2500, 7)])
def test_powerlaw_graph_matches(n, e, seed):
    for a, b in zip(jpart.powerlaw_graph(n, e, seed=seed),
                    tpart.powerlaw_graph(n, e, seed=seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_parts", [1, 2, 4, 8])
@pytest.mark.parametrize("reorder", ['locality', None])
def test_partition_edges_matches(num_parts, reorder):
    send, recv = _graph()
    _assert_parts_equal(
        jpart.partition_edges(send, recv, 64, num_parts, reorder=reorder),
        tpart.partition_edges(send, recv, 64, num_parts, reorder=reorder))


@pytest.mark.parametrize("num_parts", [2, 4])
def test_sort_split_bucketize_match(num_parts):
    send, recv = _graph(200, 2000, seed=3)
    jp = jpart.partition_edges(send, recv, 200, num_parts)
    tp = tpart.partition_edges(send, recv, 200, num_parts)
    _assert_parts_equal(jpart.sort_partition_edges(jp),
                        tpart.sort_partition_edges(tp))
    _assert_parts_equal(jpart.split_edges(jp), tpart.split_edges(tp))
    nl = -(-200 // num_parts)
    np.testing.assert_array_equal(
        jpart._edge_origin_numpy(send, recv, nl, num_parts, tp.edges_per_part),
        tpart._edge_origin_numpy(send, recv, nl, num_parts, tp.edges_per_part))
    # features follow the nodes and edges through every layout
    rng = np.random.RandomState(0)
    x = rng.randn(200, 3).astype(np.float32)
    ef = rng.randn(len(send), 2).astype(np.float32)
    for a, b in ((jp, tp),
                 (jpart.sort_partition_edges(jp),
                  tpart.sort_partition_edges(tp))):
        np.testing.assert_array_equal(a.scatter_features(x),
                                      b.scatter_features(x))
        np.testing.assert_array_equal(b.gather_outputs(b.scatter_features(x)),
                                      x)
        np.testing.assert_array_equal(a.scatter_edge_features(ef),
                                      b.scatter_edge_features(ef))


def test_neighbor_stats_labels_match():
    send, recv = _graph(500, 3000, seed=2)
    x = np.random.RandomState(1).randn(500, 4).astype(np.float32)
    np.testing.assert_array_equal(jlabels(send, recv, x, 500),
                                  tlabels(send, recv, x, 500))


def test_native_library_matches_numpy_twins():
    assert native.available(), "g++ builds the host library"
    send, recv = _graph(200, 2000, seed=3)
    num_parts, n = 4, 200
    nl = -(-n // num_parts)
    ec, hc = native.partition_stats(send, recv, nl, num_parts, n)
    np.fill_diagonal(hc, 0)
    ec2, hc2 = native.partition_stats_numpy(send, recv, nl, num_parts, n)
    np.testing.assert_array_equal(ec, ec2)
    np.testing.assert_array_equal(hc, hc2)
    el = -(-int(ec.max()) // 8) * 8
    h = -(-max(int(hc.max()), 1) // 8) * 8
    got = native.build_partition_indices(send, recv, nl, num_parts, n, el, h)
    want = tpart._partition_indices_numpy(send, recv, nl, num_parts, n, el,
                                          h)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        native.locality_order(send, recv, n),
        native.locality_order_numpy(send, recv, n))


@pytest.mark.parametrize("hub", [False, True])
def test_predict_layout_bytes_matches(hub):
    rng = np.random.RandomState(0)
    n, e = 5000, 40000
    recv = rng.randint(0, n, e)
    if hub:
        recv[:e // 4] = 0
    deg = np.bincount(recv, minlength=n)
    want = jlayout.predict_layout_bytes(deg, e, 64, dtype_bytes=2)
    f = jlayout.EDGE_WORK_FACTOR
    got = tlayout.predict_layout_bytes(
        e, 64, dtype_bytes=2, work_factors={'csr': f, 'generic': f})
    assert got == {'csr': want['pallas'], 'generic': want['generic']}


def _hub(n, e, frac=0.3, seed=0):
    rng = np.random.RandomState(seed)
    send = rng.randint(0, n, e).astype(np.int64)
    recv = rng.randint(0, n, e).astype(np.int64)
    recv[:int(e * frac)] = 0
    return send, recv


def test_choose_layout_decision_table():
    """The port's constants decide: on a card the CSR kernels whenever they
    fit, at any edge count and under a hub; without them generic, the
    segment ops on the same sorted layout; nothing fitting names the
    partition.  The budget is BUDGET_SHARE of the device's memory."""
    budget = tlayout.BUDGET_SHARE * 80 * 2 ** 30      # a card of 80 GiB
    host = os.sysconf('SC_PAGE_SIZE') * os.sysconf('SC_PHYS_PAGES')
    assert tlayout.device_budget_bytes('cpu') == tlayout.BUDGET_SHARE * host
    rng = np.random.RandomState(0)
    n = 20_000
    for e in (2_000, 200_000):
        s, r = rng.randint(0, n, e), rng.randint(0, n, e)
        c = tlayout.choose_layout(s, r, n, 64, budget)
        assert c.kernel == 'csr', c.reason
        c = tlayout.choose_layout(s, r, n, 64, budget, csr_kernels=False)
        assert c.kernel == 'generic', c.reason
        assert c.batch_kwargs == dict(sort_edges=True)
    s, r = _hub(n, e)
    assert tlayout.choose_layout(s, r, n, 64, budget).kernel == 'csr'
    assert tlayout.choose_layout(s, r, n, 64, budget,
                                 csr_kernels=False).kernel == 'generic'
    c = tlayout.choose_layout(s, r, n, 512, 2 ** 20)
    assert c.kernel == 'generic' and 'partition' in c.reason


def _sketch_case(seed=0, e=300, n=40, f=5):
    rng = np.random.RandomState(seed)
    msg = rng.randn(e, f).astype(np.float32)
    recv = rng.randint(0, n - 3, e).astype(np.int32)   # 3 empty nodes
    mask = rng.rand(e) < 0.7
    return msg, recv, mask, n


@pytest.mark.parametrize("masked", [False, True])
def test_partial_stats_match_jax(masked):
    msg, recv, mask, n = _sketch_case()
    half = len(msg) // 2
    aggs = ('mean', 'sum', 'max', 'min', 'var', 'std')
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    jsk = [jps.partial_sketch(jnp.asarray(msg[sl]), jnp.asarray(recv[sl]), n,
                              None if jm is None else jm[sl])
           for sl in (slice(0, half), slice(half, None))]
    tsk = [tps.partial_sketch(torch.from_numpy(msg[sl]),
                              torch.from_numpy(recv[sl]), n,
                              None if tm is None else tm[sl])
           for sl in (slice(0, half), slice(half, None))]
    for a, b in zip(jsk + [jps.combine(*jsk)], tsk + [tps.combine(*tsk)]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6,
                                       atol=1e-6)
    np.testing.assert_allclose(
        tps.finalize_bank(tps.combine(*tsk), aggs).numpy(),
        np.asarray(jps.finalize_bank(jps.combine(*jsk), aggs)), rtol=1e-6,
        atol=1e-6)

    # the bank's gradient with respect to the messages
    w = np.random.RandomState(1).randn(n, len(aggs), msg.shape[1]).astype(
        np.float32)

    def jloss(m):
        sk = jps.partial_sketch(m, jnp.asarray(recv), n, jm)
        return jnp.sum(jps.finalize_bank(sk, aggs) * w)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(msg)))
    tmsg = torch.from_numpy(msg).requires_grad_(True)
    sk = tps.partial_sketch(tmsg, torch.from_numpy(recv), n, tm)
    (tps.finalize_bank(sk, aggs) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tmsg.grad.numpy(), gj, rtol=1e-6, atol=1e-6)
