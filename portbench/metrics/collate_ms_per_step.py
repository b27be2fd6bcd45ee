"""Host milliseconds of batch collation per training step: the trainer's
span ``RealworldTrainer.last_pass['collate_s']`` over its steps, summed over
the window's epochs."""


def read(ctx):
    s = ctx.window.get('spans')
    if not s or not s['steps']:
        return None
    return 1000.0 * s['collate_s'] / s['steps']
