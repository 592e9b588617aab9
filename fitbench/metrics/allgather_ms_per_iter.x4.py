"""The exchange between ranks: the device time of NCCL's kernels on all
ranks, over the ranks and the iterations, milliseconds."""
from fitbench import devtrace, layers


def read(ctx):
    if not ctx.trace or not sum(ctx.iters):
        return None
    spent = sum(devtrace.kernel_seconds(t, *layers.NCCL)[0]
                for t in ctx.trace)
    if spent <= 0:
        return None
    return 1e3 * spent / len(ctx.trace) / sum(ctx.iters)
