"""Ranks: for each exchange, the start of the latest rank's first NCCL
kernel under the span ``exchange`` less each rank's, an iteration,
averaged over the ranks; see ``fitbench.progspans.exchange_wait_s``. None
where a rank launched no NCCL kernel under the span."""
from fitbench import layers


def read(ctx):
    if not ctx.trace or not all((t.get("spans") or {}).get(
            "exchange_nccl_ns") for t in ctx.trace):
        return None
    return layers.span_ms_per_iter(ctx, "exchange_wait")
