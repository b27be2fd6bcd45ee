"""PNALayerFused in bfloat16 on the bucketed, ELL and generic backends
against the JAX bfloat16 layer (tests/test_torch_layout_layer.py's setup),
and ``resolve_backend`` as a table written from
``pna_tpu/nn/fused.py:319-352``.

Tolerances, as tests/test_torch_fused_layer.py holds the CSR backends in
bfloat16: the loss rtol 1e-2 and every gradient within 5e-2 of its norm
(both sides round the same operands and sum in float32 in other orders; a
value that lands across a bfloat16 boundary moves by 2^-8 of itself, and
tied bfloat16 messages can take a max/min gradient to another edge)."""

import numpy as np
import pytest
import torch

from pna_tpu_torch.graph import batch_graphs
from pna_tpu_torch.nn.fused import resolve_backend
from tests.test_torch_layout_layer import (AGGS, LAYOUTS, SCALERS, _graphs,
                                           _run_both)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("kernel,layout,aggs,divide_input", [
    ('bucketed', 'bucketed', AGGS, True),
    ('bucketed', 'bucketed', ('mean', 'softmax', 'max'), True),
    ('ell', 'ell', AGGS, True),
    ('generic', 'csr', AGGS + ('identity',), False),
    ('generic', 'ell', AGGS + ('identity',), False),
])
def test_bf16_layer_backend_matches_jax(kernel, layout, aggs, divide_input):
    """The generic cases run with shared tower inputs: with divided inputs
    the JAX generic path contracts h with its 'ntf,tfo->nto' einsum, for
    which the XLA CPU runtime has no bfloat16 x bfloat16 -> float32 dot
    (JAX raises UNIMPLEMENTED); the bank's contraction runs in both."""
    l_t, _, pairs, _, l_j, _ = _run_both(kernel, layout, aggs,
                                         cdt=torch.bfloat16,
                                         divide_input=divide_input)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-2)
    for k, g, w in pairs:
        assert _rel(g, w) <= 5e-2, (k, _rel(g, w))


def test_resolve_backend_table():
    """Every kernel on every layout, on the CPU and on 'cuda' (the choice
    reads only the device's type), with and without 'identity'."""
    graphs = _graphs(np.random.RandomState(0))
    g = {name: batch_graphs(graphs, **kw) for name, kw in LAYOUTS.items()}
    g['ell+bucketed'] = batch_graphs(graphs, bucket_by_degree=True,
                                     with_ell=True)
    ident = AGGS + ('identity',)
    moments = ('mean', 'moment3')     # bucketed only: not ELL, not CSR
    table = [
        # kernel, layout, aggregators, device, backend
        ('auto', 'bucketed', AGGS, 'cpu', 'bucketed'),
        ('auto', 'bucketed', AGGS, 'cuda', 'bucketed'),
        ('auto', 'ell+bucketed', AGGS, 'cpu', 'bucketed'),
        ('auto', 'ell', AGGS, 'cuda', 'ell'),
        ('auto', 'ell', AGGS, 'cpu', 'ell'),
        ('auto', 'csr', AGGS, 'cuda', 'csr'),
        ('auto', 'csr', AGGS, 'cpu', 'generic'),
        ('auto', 'bucketed', ident, 'cuda', 'generic'),
        ('auto', 'ell', ident, 'cuda', 'generic'),
        ('auto', 'csr', ident, 'cuda', 'generic'),
        ('auto', 'bucketed', moments, 'cuda', 'bucketed'),
        ('auto', 'ell', moments, 'cuda', 'generic'),
        ('bucketed', 'bucketed', AGGS, 'cuda', 'bucketed'),
        ('bucketed', 'ell', AGGS, 'cuda', 'generic'),
        ('bucketed', 'csr', AGGS, 'cuda', 'generic'),
        ('ell', 'ell', AGGS, 'cpu', 'ell'),
        ('ell', 'ell+bucketed', AGGS, 'cpu', 'ell'),
        ('ell', 'bucketed', AGGS, 'cuda', 'generic'),
        ('ell', 'csr', AGGS, 'cuda', 'generic'),
        ('generic', 'bucketed', AGGS, 'cuda', 'generic'),
        ('generic', 'ell', AGGS, 'cuda', 'generic'),
        ('generic', 'csr', ident, 'cuda', 'generic'),
        ('csr', 'csr', AGGS, 'cpu', 'csr'),
        ('csr', 'ell', AGGS, 'cuda', 'csr'),
        ('csr_fused', 'csr', AGGS, 'cpu', 'csr_fused'),
        ('csr_fused', 'ell', AGGS, 'cuda', 'csr_fused'),
    ]
    for kernel, layout, aggs, dev, want in table:
        got = resolve_backend(kernel, g[layout], aggs, SCALERS, dev)
        assert got == want, (kernel, layout, aggs, dev, got)
    for kernel in ('csr', 'csr_fused'):
        with pytest.raises(ValueError, match="edge_ptr"):
            resolve_backend(kernel, g['bucketed'], AGGS, SCALERS, 'cuda')
        with pytest.raises(ValueError, match="aggregators"):
            resolve_backend(kernel, g['csr'], ident, SCALERS, 'cuda')
