"""Documents whose scores reached pinned host memory in the window, over
the window's wall time (host clock; the window ends when the last batch's
copy has been waited for)."""


def read(ctx):
    w = ctx.window
    return w["docs"] / w["wall_s"] if w.get("docs") else None
