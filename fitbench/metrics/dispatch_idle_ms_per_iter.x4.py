"""Driver and executor over the ranks: the device's idle time under the
loop's launching spans, an iteration, averaged over the ranks; see
``fitbench.progspans.per_iter_ms``."""
from fitbench import layers


def read(ctx):
    return layers.span_ms_per_iter(ctx, "dispatch_idle")
