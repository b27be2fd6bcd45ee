"""Host milliseconds of Adam's step per training step, epochs of small
graphs in batches (the ZINC cell): the median of the program's span
``pna.optimizer`` (``pna_tpu_torch/utils/profiling.py::span_stats``) over
the process's calls, which the window's steps outnumber. None where the
program has no such span, and off the card, where the span times the CPU's
compute and not the card's host."""


def read(ctx):
    if ctx.driver.device.type != 'cuda':
        return None
    try:
        from pna_tpu_torch.utils.profiling import span_stats
    except ImportError:             # a program without the span registry
        return None
    s = span_stats().get('pna.optimizer')
    return None if s is None else 1000.0 * s['host_median_s']
