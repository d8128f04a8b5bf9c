"""Host seconds of ``device_scorer`` in set-up: the model's scoring tables
built on the host and uploaded, ending in a device sync."""


def read(ctx):
    return ctx.setup.get("tables_s")
