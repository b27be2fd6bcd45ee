"""PNALayerFused in bfloat16 on the receiver-sorted batch against the JAX
bfloat16 layer on its bucketed, ELL and CSR batches (the setup of
tests/test_torch_layout_layer.py, whose JAX bucketed and ELL cases the port
holds on ``csr``, or ``generic`` where the aggregators need the segment
form), and ``resolve_backend`` as a table.

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
from tests.test_torch_layout_layer import AGGS, _graphs, _note, _run_both


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


BF16_CASES = {
    # id: (JAX kernel, JAX batch layout, aggregators, divide_input, port
    # kernel).  The JAX bucketed raw bank's case (softmax, softmin) is held
    # against the JAX generic path: that bank rounds the messages to
    # bfloat16, where the port's one backend for softmax, generic, keeps
    # them in float32 as the JAX generic path does
    'bucketed-bucketed-aggs0-True': ('bucketed', 'bucketed', AGGS, True,
                                     'csr'),
    'bucketed-bucketed-aggs1-True': ('generic', 'csr',
                                     ('mean', 'softmax', 'softmin', 'max'),
                                     False, 'generic'),
    'ell-ell-aggs2-True': ('ell', 'ell', AGGS, True, 'csr'),
    'generic-csr-aggs3-False': ('generic', 'csr', AGGS + ('identity',),
                                False, 'generic'),
    'generic-ell-aggs4-False': ('generic', 'ell', AGGS + ('identity',),
                                False, 'generic'),
}


@pytest.mark.parametrize(
    "kernel,layout,aggs,divide_input,port_kernel",
    list(BF16_CASES.values()), ids=list(BF16_CASES))
def test_bf16_layer_backend_matches_jax(kernel, layout, aggs, divide_input,
                                        port_kernel):
    """The JAX generic cases run with shared tower inputs: with divided
    inputs the JAX generic path contracts h with its 'ntf,tfo->nto' einsum,
    for which the XLA CPU runtime has no bfloat16 x bfloat16 -> float32 dot
    (JAX raises UNIMPLEMENTED); the bank's contraction runs in both."""
    l_t, _, pairs, _, l_j, _ = _run_both(kernel, layout, aggs,
                                         cdt=torch.bfloat16,
                                         divide_input=divide_input,
                                         port_kernel=port_kernel)
    note = _note(kernel, layout, aggs)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-2, err_msg=note)
    for k, g, w in pairs:
        assert _rel(g, w) <= 5e-2, (k, _rel(g, w), note)


IDENT = AGGS + ('identity',)
MOMENTS = ('mean', 'moment3')          # not in the CSR bank
RESOLVE = [
    # kernel, batch ('csr': receiver-sorted with edge_ptr; 'unsorted':
    # sort_edges=False, no edge_ptr), aggregators, device, backend or the
    # ValueError's message
    ('auto', 'csr', AGGS, 'cuda', 'csr'),
    ('auto', 'csr', AGGS, 'cpu', 'generic'),
    ('auto', 'csr', IDENT, 'cuda', 'generic'),
    ('auto', 'csr', MOMENTS, 'cuda', 'generic'),
    ('auto', 'unsorted', AGGS, 'cuda', 'generic'),
    ('auto', 'unsorted', AGGS, 'cpu', 'generic'),
    ('generic', 'csr', AGGS, 'cuda', 'generic'),
    ('generic', 'csr', IDENT, 'cuda', 'generic'),
    ('generic', 'unsorted', MOMENTS, 'cpu', 'generic'),
    ('csr', 'csr', AGGS, 'cpu', 'csr'),
    ('csr', 'csr', AGGS, 'cuda', 'csr'),
    ('csr_fused', 'csr', AGGS, 'cpu', 'csr_fused'),
    ('csr_fused', 'csr', AGGS, 'cuda', 'csr_fused'),
    ('csr', 'unsorted', AGGS, 'cuda', 'edge_ptr'),
    ('csr_fused', 'unsorted', AGGS, 'cuda', 'edge_ptr'),
    ('csr', 'csr', IDENT, 'cuda', 'aggregators'),
    ('csr_fused', 'csr', MOMENTS, 'cpu', 'aggregators'),
]


@pytest.mark.parametrize(
    "kernel,batch,aggs,dev,want", RESOLVE,
    ids=[f"{k}-{b}-{len(a)}-{d}" for k, b, a, d, _ in RESOLVE])
def test_resolve_backend_table(kernel, batch, aggs, dev, want):
    """Every kernel on a batch with and without ``edge_ptr``, on the CPU and
    on 'cuda' (the choice reads only the device's type), with aggregators
    the CSR bank covers and ones it does not."""
    graphs = _graphs(np.random.RandomState(0))
    g = batch_graphs(graphs, sort_edges=batch == 'csr')
    assert (g.edge_ptr is None) == (batch == 'unsorted')
    if want in ('edge_ptr', 'aggregators'):
        with pytest.raises(ValueError, match=want):
            resolve_backend(kernel, g, aggs, dev)
    else:
        assert resolve_backend(kernel, g, aggs, dev) == want
