"""K3, one card: see ``fitbench.layers.k3_roofline``."""
from fitbench import layers


def read(ctx):
    return layers.k3_roofline(ctx, ctx.m)
