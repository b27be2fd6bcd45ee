"""Readings that metrics of several cells share; each metric's own file
(``metrics/<name>.py``) says which it reads and for which cells."""

from portbench import counts


def edges_per_s(ctx):
    """The real edges of every step the window completed, times the message
    layers, over the window's whole time (host clock)."""
    return ctx.window['work_edges'] / ctx.window['seconds']


def kernels_per_step(ctx):
    """Device kernels per traced step (copies and sets not counted)."""
    t = ctx.trace
    if t is None or not t.steps or not t.n_kernels:
        return None
    return t.n_kernels / t.steps


def device_idle_share(ctx):
    """The share (%) of the traced range's host wall time in which no
    operation ran on the device, from one trace."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def step_mfu(ctx):
    """The whole step's share (%) of the card's peak: the FLOPs the traced
    steps need (``counts.step_flops`` of their real nodes, edges and
    graphs) over the traced range's time, over the peak of the dtype the
    configuration states (float32 with TF32 off: the CUDA cores)."""
    t, peak = ctx.trace, ctx.peak
    if t is None or peak is None or t.window_s <= 0:
        return None
    w = ctx.driver.traced_work
    flops = counts.step_flops(ctx.driver.net, ctx.driver.head, w['nodes'],
                              w['edges'], w['graphs'])
    return 100.0 * flops / t.window_s / peak[ctx.cell.config['run']['dtype']]
