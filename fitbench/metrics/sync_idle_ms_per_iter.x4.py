"""Driver and executor over the ranks: the device's idle time under the
span ``host_sync``, an iteration, averaged over the ranks; see
``fitbench.progspans.per_iter_ms``."""
from fitbench import layers


def read(ctx):
    return layers.span_ms_per_iter(ctx, "sync_idle")
