"""Algorithm 2 over the ranks of a process group: on every rank
``solve_with_executor`` on a ``ShardMapExecutor`` (its rows of D: the Gram
by K2a, summed over the ranks once; K3 each iteration, then one all-gather
of the packed (3n + 4) vector), with the history off.

The executor takes the global D, the same on every rank, and keeps a view
of its own rows: each rank holds the whole D on its card."""
from __future__ import annotations


def prepare(cfg: dict, inputs: dict, device, group=None):
    """A function of one request (any: every fit is the same) that runs
    one whole fit on this rank and returns {"x", "iters"}; every rank of
    ``group`` calls it together."""
    from repro_torch.core import prox
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.exec.base import solve_with_executor
    from repro_torch.exec.shard_map import ShardMapExecutor

    solver = UnwrappedADMM(loss=getattr(prox, f"make_{cfg['loss']}")(),
                           tau=float(cfg["tau"]),
                           eps_rel=float(cfg["eps_rel"]),
                           eps_abs=float(cfg["eps_abs"]),
                           residency=cfg.get("residency"),
                           device=str(device))
    D, labels = inputs["D"], inputs["labels"]
    max_iters = int(cfg["max_iters"])

    def fit(request=None):
        ex = ShardMapExecutor(solver.engine, D, labels, group=group)
        res = solve_with_executor(ex, loss=solver.loss, tau=solver.tau,
                                  rho=solver.rho, eps_rel=solver.eps_rel,
                                  eps_abs=solver.eps_abs,
                                  max_iters=max_iters)
        return {"x": res.x, "iters": int(res.iters)}
    return fit
