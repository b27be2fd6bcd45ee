"""The PNA layer's scaled posttrans's share (%) of its roofline in a
training step: per launch of the forward kernel and of the backward kernel
(its merge included) the least time at a layer's shape (``counts.bound_s``;
forward: z [N, A, T Ft], h, w [S, N] read and out [N, T, Fo] written once,
2 N T (A S Ft Fo + Ft Fo) float32 operations; backward: d_out, z, h, w read
and d_z, d_h written once, twice the forward's operations), the launches
spread over the net's layers alike (one a layer a step each way), over the
device time of the three kernels.  None where the trace shows no such
kernel (a program without it)."""

from portbench import counts
from portbench.reference.pna import layer_shapes

FWD = ('scaled_posttrans_fwd_kernel',)
BWD = ('scaled_posttrans_bwd_kernel',)
ALL = FWD + BWD + ('scaled_posttrans_merge_kernel',)


def posttrans_bytes(n: int, t: int, ft: int, fo: int, a: int, s: int,
                    divide: bool, backward: bool) -> int:
    z, h, w, o = n * a * t * ft, n * (t * ft if divide else ft), s * n, \
        n * t * fo
    return counts.F32 * (2 * z + 2 * h + w + o if backward
                         else z + h + w + o)


def posttrans_flops(n: int, t: int, ft: int, fo: int, a: int, s: int,
                    backward: bool) -> int:
    return (2 if backward else 1) * 2 * n * t * (a * s * ft * fo + ft * fo)


def read(ctx):
    t, peak = ctx.trace, ctx.peak
    shape = getattr(ctx.driver, 'aggregation_shape', None)
    net = getattr(ctx.driver, 'net', None)
    if t is None or peak is None or shape is None or net is None:
        return None
    n_fwd, _ = t.kernel_time(FWD)
    n_bwd, _ = t.kernel_time(BWD)
    _, seconds = t.kernel_time(ALL)
    if n_fwd + n_bwd == 0 or seconds <= 0:
        return None
    n = shape()['nodes']
    a, s = len(net['aggregators']), len(net['scalers'])
    layers = layer_shapes(net)

    def bound(backward: bool) -> float:
        return sum(counts.bound_s(
            posttrans_bytes(n, x['towers'], x['ft'], x['fo'], a, s,
                            x['divide'], backward),
            posttrans_flops(n, x['towers'], x['ft'], x['fo'], a, s,
                            backward), peak) for x in layers) / len(layers)

    return 100.0 * (n_fwd * bound(False) + n_bwd * bound(True)) / seconds
