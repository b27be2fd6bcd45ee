"""The device memory the program held at its peak in the window:
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start, read by the harness."""


def read(ctx):
    b = ctx.window_peak_bytes
    return None if b is None else b / 2 ** 30
