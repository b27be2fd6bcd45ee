"""Host milliseconds per training step spent waiting for the device at the
step's loss read: the trainer's span ``last_pass['sync_s']`` over its steps,
summed over the window's epochs.  It grows as the host gets faster."""


def read(ctx):
    s = ctx.window.get('spans')
    if not s or not s['steps']:
        return None
    return 1000.0 * s['sync_s'] / s['steps']
