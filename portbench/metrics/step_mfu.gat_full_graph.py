"""The whole GAT training step's share (%) of the card's float32 peak over
full-graph steps of one large graph: the FLOPs the traced steps need
(``portbench/counts_gat.py::step_flops`` of their real nodes and edges)
over the traced range's time, over the peak of the dtype the configuration
states (float32 with TF32 off: the CUDA cores)."""

from portbench import counts_gat


def read(ctx):
    t, peak = ctx.trace, ctx.peak
    if t is None or peak is None or t.window_s <= 0:
        return None
    w = ctx.driver.traced_work
    flops = counts_gat.step_flops(ctx.driver.net, w['nodes'], w['edges'])
    return 100.0 * flops / t.window_s / peak[ctx.cell.config['run']['dtype']]
