"""Host seconds of ``TrainData.build`` in set-up (binning of the train
fold, upload), ending in a device sync."""


def read(ctx):
    return ctx.setup.get("init_s")
