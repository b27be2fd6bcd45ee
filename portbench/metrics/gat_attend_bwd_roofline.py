"""The GAT attention backward's share (%) of its roofline in a training
step: the least time of every backward launch the trace shows, at its
layer's shape (``portbench/counts_gat.py``: the bytes it must move over
3.35 TB/s, or its float32 operations over the peak, the larger), over the
device time of its kernels: the receiver pass (whose launches count the
backward's), the sender pass and a split sender's two merge kernels.  None
where the trace shows no such kernel."""

from portbench import counts, counts_gat

LAUNCH = ('gat_attend_bwd_recv_kernel',)
ALL = ('gat_attend_bwd_recv_kernel', 'gat_attend_bwd_send_kernel',
       'gat_attend_merge_runs_kernel', 'gat_attend_merge_final_kernel')


def read(ctx):
    t, peak = ctx.trace, ctx.peak
    shapes = getattr(ctx.driver, 'attention_shapes', None)
    if t is None or peak is None or shapes is None:
        return None
    n, _ = t.kernel_time(LAUNCH)
    _, seconds = t.kernel_time(ALL)
    layers = shapes()
    if n == 0 or seconds <= 0 or n % len(layers):
        return None
    bound = sum(counts.bound_s(
        counts_gat.attend_bwd_bytes(s['nodes'], s['table'], s['edges'],
                                    s['heads'], s['f']),
        counts_gat.attend_bwd_ops(s['nodes'], s['edges'], s['heads'],
                                  s['f']),
        peak) for s in layers)
    return 100.0 * (n // len(layers)) * bound / seconds
