"""The row sum's share (%) of its roofline in a training step: the least time
of every row-sum launch the trace shows (each the backward of a gather of
the layer's input by the graph's edges, at that shape: ``portbench/
counts.py::row_sum_bytes``) over the device time of the row sum's two
kernels."""

from portbench import counts

TILES = ('sorted_row_sum_tiles',)
ALL = ('sorted_row_sum',)


def read(ctx):
    t, peak = ctx.trace, ctx.peak
    shape = getattr(ctx.driver, 'aggregation_shape', None)
    if t is None or peak is None or shape is None:
        return None
    s = shape()
    n, _ = t.kernel_time(TILES)
    _, seconds = t.kernel_time(ALL)
    if n == 0 or seconds <= 0:
        return None
    rows, nodes, f = s['rows'], s['nodes'], s['f']
    return 100.0 * n * counts.bound_s(counts.row_sum_bytes(rows, nodes, f),
                              counts.ROW_SUM_OPS * rows * f,
                              peak) / seconds
