"""Driver and executor, one card: the device's idle time under the loop's
launching spans (``iterate``, ``x_solve``, ``sweep``, ``stop_terms``,
``exchange``), an iteration; see ``fitbench.progspans.per_iter_ms``."""
from fitbench import layers


def read(ctx):
    return layers.span_ms_per_iter(ctx, "dispatch_idle")
