"""Seconds from the process's start to the opening of the window: drawing
the inputs, the program's set-up (binning and upload, or tables), the
kernel build where one is due, and the warm-up."""


def read(ctx):
    return ctx.setup["setup_s"]
