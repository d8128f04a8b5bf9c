"""The program's count of split decisions read back to the host
(``trees/grow.py::HOST_SYNCS``) over the window, a tree."""


def read(ctx):
    w = ctx.window
    return w["host_syncs"] / w["trees"] if w.get("trees") else None
