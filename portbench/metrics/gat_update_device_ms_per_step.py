"""Device milliseconds of the GAT layers' update phase per training step,
full-graph steps of one large graph: the device time of the program's span
``gat.update`` (``pna_tpu_torch/nn/gat.py``, timed by
``pna_tpu_torch/utils/profiling.py::span_stats``, CUDA events, taken only
while the profiler runs), summed over the layers, over the traced steps.
None where the program has no such span."""


def read(ctx):
    try:
        from pna_tpu_torch.utils.profiling import span_stats
    except ImportError:             # a program without the span registry
        return None
    s = span_stats().get('gat.update')
    t = ctx.trace
    if s is None or not s['device_calls'] or t is None or not t.steps:
        return None
    return 1000.0 * s['device_s'] / t.steps
