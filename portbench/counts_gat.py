"""The work a GAT step needs, counted from shapes: the yardstick of
``step_mfu.gat_full_graph`` and of the GAT attention's rooflines.

FLOPs (``step_flops``), 2 per multiply-add, per layer: the projection of
every node (fin x H F), the two head scores of every node (H F each), the
skip connection where the layer has one (fin x H F), and the attention's
weighted sum over every edge and self term (H F); the logits, softmax,
biases and ELU are elementwise and not counted.  Forward and backward are
three forwards, as ``counts.step_flops`` counts PNA's.  The count is the
same whatever implements the step.

Bytes (``attend_bytes``, ``attend_bwd_bytes``) are a lower bound of what
one launch must move at a layer's shape, each input read once and each
output written once: the forward reads hw, s_src, s_dst, the int32 senders
and the row pointers and writes out, m and l; the backward reads hw, out,
d_out, the four head-scalar tables, the attention vectors, the senders and
row pointers, and writes d_hw, d_s_src and d_s_dst.  Whatever a kernel
reads again (a row per edge) is not counted, so the share cannot pass
100%.
"""

from __future__ import annotations

from portbench.reference.gat import layer_dims

F32 = 4


def forward_flops(net: dict, nodes: int, edges: int) -> int:
    total = 0
    for d in layer_dims(net):
        hf = d['heads'] * d['f']
        total += 2 * nodes * d['fin'] * hf            # projection
        total += 2 * 2 * nodes * hf                   # s_src, s_dst
        if d['residual']:
            total += 2 * nodes * d['fin'] * hf        # skip connection
        total += 2 * (edges + nodes) * hf             # weighted sum
    return total


def step_flops(net: dict, nodes: int, edges: int) -> int:
    """Forward and backward of a training step over these real nodes and
    edges."""
    return 3 * forward_flops(net, nodes, edges)


def attend_bytes(nodes: int, table: int, edges: int, heads: int,
                 f: int) -> int:
    hf = heads * f
    return F32 * (table * hf + table * heads + nodes * heads) \
        + 4 * edges + 4 * (nodes + 1) \
        + F32 * (nodes * hf + 2 * nodes * heads)


def attend_bwd_bytes(nodes: int, table: int, edges: int, heads: int,
                     f: int) -> int:
    hf = heads * f
    return F32 * (table * hf + 2 * nodes * hf + table * heads
                  + 3 * nodes * heads + 2 * hf) \
        + 4 * edges + 4 * (nodes + 1) \
        + F32 * (table * hf + table * heads + nodes * heads)


def attend_ops(nodes: int, edges: int, heads: int, f: int) -> int:
    """The forward's float32 operations: a multiply and an add a row
    element an edge or self term."""
    return 2 * (edges + nodes) * heads * f


def attend_bwd_ops(nodes: int, edges: int, heads: int, f: int) -> int:
    """The backward's: a dot product with the receiver's gradient and a
    weighted sum by sender, each a multiply and an add an element."""
    return 4 * (edges + nodes) * heads * f
