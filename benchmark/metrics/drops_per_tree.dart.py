"""Trees dropped a tree over the measured window: the sum of each job's
``history["dropped_per_iter"]`` over the trees the jobs grew."""


def read(ctx):
    w = ctx.window
    return w["dropped"] / w["trees"] if w.get("trees") and "dropped" in w else None
