"""A spawn target for the obs tests, in a module a rank imports without
JAX: one ``ShardMapExecutor`` solve untraced and one under
``repro_torch.obs.recording``."""
from collections import Counter


def traced_shard_solve(D, labels, iters):
    """This rank's x untraced (``x0``) and traced (``x1``), the traced
    solve's iterations and its span names counted."""
    import torch

    from repro_torch import obs
    from repro_torch.core import prox
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.exec import ShardMapExecutor, solve_with_executor

    solver = UnwrappedADMM(loss=prox.make_logistic(), tau=0.1,
                           device="cpu")

    def solve():
        ex = ShardMapExecutor(solver.engine, torch.as_tensor(D),
                              torch.as_tensor(labels))
        return solve_with_executor(ex, loss=solver.loss, tau=solver.tau,
                                   max_iters=iters)

    plain = solve()
    ob = obs.Observability(enabled=True)
    with obs.recording(ob):
        traced = solve()
    counts = Counter(e["name"] for e in ob.tracer.events()
                     if e.get("ph") == "X")
    return {"x0": plain.x, "x1": traced.x, "iters": traced.iters,
            "counts": dict(counts)}
