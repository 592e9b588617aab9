"""Whole fit, each rank on its rows: see ``fitbench.layers.fit_mfu``."""
from fitbench import layers


def read(ctx):
    return layers.fit_mfu(ctx, ctx.m_rank)
