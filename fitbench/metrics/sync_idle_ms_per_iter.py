"""Driver and executor, one card: the device's idle time under the span
``host_sync`` (the loop's one ``.tolist()``), an iteration; see
``fitbench.progspans.per_iter_ms``."""
from fitbench import layers


def read(ctx):
    return layers.span_ms_per_iter(ctx, "sync_idle")
