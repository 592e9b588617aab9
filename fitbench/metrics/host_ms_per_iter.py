"""Driver and executor, one card: see
``fitbench.layers.host_ms_per_iter``."""
from fitbench import layers


def read(ctx):
    return layers.host_ms_per_iter(ctx)
