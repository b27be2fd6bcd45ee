"""Seconds from the process's start to the window's first step: imports, the
CUDA context, the kernel library's load (and build, in a fresh checkout),
the inputs, the model, the first steps and the warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
