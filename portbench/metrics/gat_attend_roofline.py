"""The GAT attention forward's share (%) of its roofline in a training
step: the least time of every launch of the forward kernel the trace shows,
at its layer's shape (``portbench/counts_gat.py``: the bytes it must move
over 3.35 TB/s, or its float32 operations over the peak, the larger), over
the device time of those launches.  A step launches it once a layer, in the
layers' order.  None where the trace shows no such kernel."""

from portbench import counts, counts_gat

KERNEL = ('gat_attend_fwd_kernel',)


def read(ctx):
    t, peak = ctx.trace, ctx.peak
    shapes = getattr(ctx.driver, 'attention_shapes', None)
    if t is None or peak is None or shapes is None:
        return None
    n, seconds = t.kernel_time(KERNEL)
    layers = shapes()
    if n == 0 or seconds <= 0 or n % len(layers):
        return None
    bound = sum(counts.bound_s(
        counts_gat.attend_bytes(s['nodes'], s['table'], s['edges'],
                                s['heads'], s['f']),
        counts_gat.attend_ops(s['nodes'], s['edges'], s['heads'], s['f']),
        peak) for s in layers)
    return 100.0 * (n // len(layers)) * bound / seconds
