"""K3 on each rank's rows: see ``fitbench.layers.k3_roofline``."""
from fitbench import layers


def read(ctx):
    return layers.k3_roofline(ctx, ctx.m_rank)
