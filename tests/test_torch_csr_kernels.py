"""K1 csr_moment_sketch and K2 csr_dmsg: on the CPU their wrappers take the
plain PyTorch versions, held here against the Pallas kernels
sorted_moment_sketch / sorted_dmsg run in interpret mode, on the layout cases
of tests/test_torch_cuda.py (where the CUDA kernels are held against the
plain versions on a card).

Tolerances: sum and sumsq rtol 1e-5, atol 1e-5 (the TPU kernel adds with
one-hot matmuls, in another order); max, min and tie counts exactly equal;
d_msg rtol 1e-5, atol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pna_tpu.ops.pallas_kernels import sorted_dmsg, sorted_moment_sketch
from pna_tpu_torch.ops import csr_kernels as ck
from tests.test_torch_cuda import CASES, F, sketch_case, valid_rows
from tests.test_torch_cuda import layout_case as _case


@pytest.mark.parametrize("case", CASES)
def test_moment_sketch_matches_pallas(case):
    msg, ptr = _case(case)
    for with_ties in (False, True):
        got = ck.csr_moment_sketch(torch.from_numpy(msg),
                                   torch.from_numpy(ptr), with_ties)
        want = sorted_moment_sketch(jnp.asarray(msg), jnp.asarray(ptr),
                                    with_ties=with_ties, interpret=True)
        assert len(got) == len(want) == (6 if with_ties else 4)
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.numpy(), np.asarray(w)
            if i < 2:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(g, w)
    deg = np.diff(ptr)
    s, sq, mx, mn, tmx, tmn = (x.numpy() for x in got)
    assert np.all(mx[deg == 0] == 0) and np.all(tmx[deg == 0] == 1)
    if case == "empty_nodes":
        assert (deg == 0).sum() > 10
    if case == "hub":
        assert deg.max() > 256
    assert tmx.max() >= 2           # the duplicated rows tie somewhere


@pytest.mark.parametrize("case", CASES)
def test_dmsg_matches_pallas(case):
    msg, ptr = _case(case)
    n = len(ptr) - 1
    rng = np.random.RandomState(1)
    s, sq, mx, mn, tmx, tmn = ck.csr_moment_sketch(
        torch.from_numpy(msg), torch.from_numpy(ptr), True)
    g = [rng.randn(n, F).astype(np.float32) for _ in range(4)]
    g[2] /= tmx.numpy()
    g[3] /= tmn.numpy()
    fields = g + [mx.numpy(), mn.numpy()]
    got = ck.csr_dmsg(torch.from_numpy(msg), torch.from_numpy(ptr),
                      *map(torch.from_numpy, fields)).numpy()
    want = np.asarray(sorted_dmsg(jnp.asarray(msg), jnp.asarray(ptr),
                                  *map(jnp.asarray, fields), interpret=True))
    valid = valid_rows(ptr, len(msg))
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5, atol=1e-6)
    assert np.all(got[~valid] == 0)


def test_wrappers_check_inputs():
    msg = torch.randn(10, 4)
    ptr = torch.tensor([0, 3, 10], dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        ck.csr_moment_sketch(msg.double(), ptr)
    with pytest.raises(ValueError, match="int32"):
        ck.csr_moment_sketch(msg, ptr.long())
    with pytest.raises(ValueError, match="contiguous"):
        ck.csr_moment_sketch(torch.randn(4, 10).t(), ptr)
    with pytest.raises(ValueError, match="node fields"):
        ck.csr_dmsg(msg, ptr, *([torch.zeros(3, 4)] * 6))
    with pytest.raises(ValueError, match="device"):
        ck.csr_moment_sketch(msg.to("meta"), ptr.to("meta"))


@pytest.mark.parametrize("f", [F, 75])
def test_kernels_with_the_segment_table_match_pallas(f):
    """Whole and split nodes, rows before ptr[0] and after ptr[N], ties
    across segment cuts, at an even and an odd width: the wrappers given the
    layout's table against the Pallas kernels."""
    msg, ptr, tie_node = sketch_case(f)
    m, p = torch.from_numpy(msg), torch.from_numpy(ptr)
    segs = ck.csr_segments(p)
    assert segs.n_split == 4
    got = ck.csr_moment_sketch(m, p, True, segments=segs)
    want = sorted_moment_sketch(jnp.asarray(msg), jnp.asarray(ptr),
                                with_ties=True, interpret=True)
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 2:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert torch.all(got[4][tie_node] == 2) and torch.all(got[5][tie_node] == 2)
    rng = np.random.RandomState(2)
    g = [rng.randn(len(ptr) - 1, f).astype(np.float32) for _ in range(4)]
    g[2] /= got[4].numpy()
    g[3] /= got[5].numpy()
    fields = g + [got[2].numpy(), got[3].numpy()]
    d = ck.csr_dmsg(m, p, *map(torch.from_numpy, fields),
                    segments=segs).numpy()
    want = np.asarray(sorted_dmsg(jnp.asarray(msg), jnp.asarray(ptr),
                                  *map(jnp.asarray, fields), interpret=True))
    valid = valid_rows(ptr, len(msg))
    np.testing.assert_allclose(d[valid], want[valid], rtol=1e-5, atol=1e-6)
    assert (~valid).sum() == 12 and np.all(d[~valid] == 0)
