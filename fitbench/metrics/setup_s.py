"""Set-up: from the process's start to the first timed fit (imports, the
kernels' build or load, the data made on the device, the warm fits)."""


def read(ctx):
    return ctx.setup_s
