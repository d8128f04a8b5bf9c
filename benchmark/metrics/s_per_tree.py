"""Wall seconds of the measured window over the trees its jobs grew (host
clock around whole ``learn`` calls, each ending in a host read)."""


def read(ctx):
    w = ctx.window
    return w["wall_s"] / w["trees"] if w.get("trees") else None
