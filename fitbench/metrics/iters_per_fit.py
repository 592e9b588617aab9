"""ADMM iterations a fit (Boyd's rule or the cap), as each fit returned
them, averaged over the window."""


def read(ctx):
    return sum(ctx.iters) / len(ctx.iters) if ctx.iters else None
