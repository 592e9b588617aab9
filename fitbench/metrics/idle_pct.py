"""Device, one card: see ``fitbench.layers.idle_pct``."""
from fitbench import layers


def read(ctx):
    return layers.idle_pct(ctx)
