"""Arithmetic the per-layer metric readers share, over the ranks' trace
summaries (``devtrace.summarize``, with the program's spans under
``spans``: ``harness``)."""
from fitbench import devtrace, progspans, roofline

K3 = ("admm_ring_kernel", "admm_iter_kernel", "admm_reduce_kernel")
NCCL = ("nccl",)


def fit_mfu(ctx, rows):
    """Percent: the fits' roofline floors (each on ``rows`` rows a rank)
    over the traced fits' time, summed over the ranks."""
    if not ctx.trace or not ctx.iters:
        return None
    floor = sum(roofline.fit_floor_s(ctx.cfg, rows, ctx.n, it, ctx.peaks)
                for it in ctx.iters) * len(ctx.trace)
    spent = sum(s for t in ctx.trace for s, _ in t["fits"])
    return 100.0 * floor / spent if spent > 0 else None


def k3_roofline(ctx, rows):
    """Percent: the iterations' K3 floors over K3's device time (the ring
    or wide kernel and its second stage), summed over the ranks."""
    if not ctx.trace or not sum(ctx.iters):
        return None
    spent = sum(devtrace.kernel_seconds(t, *K3)[0] for t in ctx.trace)
    if spent <= 0:
        return None
    each = roofline.floor_s(*roofline.stage("admm_iter", rows, ctx.n,
                                            ctx.cfg), ctx.peaks)
    return 100.0 * each * sum(ctx.iters) * len(ctx.trace) / spent


def host_ms_per_iter(ctx):
    """Milliseconds an iteration in which the device ran nothing while a
    fit was on: each fit's wall time less its busy time, over the
    iterations, averaged over the ranks."""
    if not ctx.trace or not sum(ctx.iters):
        return None
    idle = [sum(s - b for s, b in t["fits"]) for t in ctx.trace]
    return 1e3 * sum(idle) / len(idle) / sum(ctx.iters)


def idle_pct(ctx):
    """Percent of the traced window in which no device operation ran,
    averaged over the ranks."""
    if not ctx.trace:
        return None
    return 100.0 * sum(1.0 - t["busy_s"] / t["window_s"]
                       for t in ctx.trace) / len(ctx.trace)


def span_ms_per_iter(ctx, key):
    """Milliseconds an iteration of ``progspans.per_iter_ms``'s ``key``,
    over the ranks' span tables; None when the run is untraced or a rank
    has no table or no iteration in it."""
    if not ctx.trace or any(not (t.get("spans") or {}).get("iters")
                            for t in ctx.trace):
        return None
    return progspans.per_iter_ms([t["spans"] for t in ctx.trace]).get(key)
