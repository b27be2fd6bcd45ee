"""The CSR aggregation bank's share (%) of its roofline in a training step:
the least time of every K1 (forward moment sketch with tie counts) and K2
(backward) launch the trace shows, from the bytes each needs at the
layer's shape (``portbench/counts.py``), over the device time of those
kernels and of the sketch merge of split nodes."""

from portbench import counts

K1 = ('csr_moment_sketch_kernel',)
K2 = ('csr_dmsg_kernel',)
MERGE = ('sketch_merge_kernel',)


def read(ctx):
    t, peak = ctx.trace, ctx.peak
    shape = getattr(ctx.driver, 'aggregation_shape', None)
    if t is None or peak is None or shape is None:
        return None
    s = shape()
    rows, nodes, f = s['rows'], s['nodes'], s['f']
    n1, s1 = t.kernel_time(K1)
    n2, s2 = t.kernel_time(K2)
    _, s3 = t.kernel_time(MERGE)
    if n1 + n2 == 0 or s1 + s2 + s3 <= 0:
        return None
    bound = (n1 * counts.bound_s(counts.k1_bytes(rows, nodes, f),
                                 counts.K1_OPS * rows * f, peak)
             + n2 * counts.bound_s(counts.k2_bytes(rows, nodes, f),
                                   counts.K2_OPS * rows * f, peak))
    return 100.0 * bound / (s1 + s2 + s3)
