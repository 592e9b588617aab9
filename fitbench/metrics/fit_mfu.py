"""Whole fit, one card: see ``fitbench.layers.fit_mfu``."""
from fitbench import layers


def read(ctx):
    return layers.fit_mfu(ctx, ctx.m)
