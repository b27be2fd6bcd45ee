"""The work a step needs, counted from shapes: the yardstick of ``step_mfu``
and the roofline metrics.

FLOPs (``step_flops``) count each matrix product once at its own width, 2
per multiply-add: a tower's product at the tower's width (no zero blocks of
a block-diagonal weight); the first pretrans layer as its node-level
decomposition (each node's sender and receiver halves, and the edge-feature
product per edge); later pretrans layers per edge; posttrans, mixing, the
embedding of node features and the readout MLP (per graph, or per node for a
node-level net).  Forward and backward are three forwards; no recomputation
counts.  So the count is the same whatever implements the step.

Bytes are those an operation needs, each input read once and each output
written once (copies of the counts of ``pna_tpu_torch/ops/timing.py``'s
``time_csr_kernels``): K1, the forward moment sketch with tie counts, reads
the messages and writes six node fields; K2, the backward, reads the
messages, each row's node and six node fields and writes the message
gradient; the row sum reads its rows, their int32 keys and the row pointers
and writes the sums.
"""

from __future__ import annotations

from portbench.reference.pna import layer_shapes, mlp_readout_dims

F32 = 4


def forward_flops(net: dict, head: str, nodes: int, edges: int,
                  graphs: int) -> int:
    total = 0
    if head == 'node':
        total += 2 * nodes * net['feat_dim'] * net['hidden_dim']
    for s in layer_shapes(net):
        T, pre, post = s['towers'], s['pre'], s['post']
        total += 2 * 2 * nodes * T * s['ft'] * pre[1]
        total += 2 * edges * s['fe'] * T * pre[1]
        for j in range(1, len(pre) - 1):
            total += 2 * edges * T * pre[j] * pre[j + 1]
        for j in range(len(post) - 1):
            total += 2 * nodes * T * post[j] * post[j + 1]
        total += 2 * nodes * T * s['fo'] * s['d_out']
    rows = graphs if head == 'molecules' else nodes
    dims = mlp_readout_dims(net['out_dim'], 1)
    total += 2 * rows * sum(a * b for a, b in zip(dims, dims[1:]))
    return total


def step_flops(net: dict, head: str, nodes: int, edges: int,
               graphs: int) -> int:
    """Forward and backward of a training step over these real nodes,
    edges and graphs."""
    return 3 * forward_flops(net, head, nodes, edges, graphs)


def k1_bytes(rows: int, nodes: int, f: int) -> int:
    return F32 * rows * f + 6 * F32 * nodes * f


def k2_bytes(rows: int, nodes: int, f: int) -> int:
    return 2 * F32 * rows * f + 4 * rows + 6 * F32 * nodes * f


def row_sum_bytes(rows: int, nodes: int, f: int) -> int:
    return F32 * rows * f + 4 * rows + 4 * (nodes + 1) + F32 * nodes * f


# float32 operations per message element: K1 adds, squares and adds, and
# takes max, min and two tie tests; K2 forms four terms and adds them; the
# row sum adds
K1_OPS, K2_OPS, ROW_SUM_OPS = 7, 8, 1


def bound_s(nbytes: float, ops: float, peak: dict) -> float:
    """The least time of an operation on a card of ``peak``: the larger of
    its bytes over the memory's rate and its float32 operations over the
    CUDA cores' rate."""
    return max(nbytes / peak['hbm_bytes_per_s'], ops / peak['float32'])
