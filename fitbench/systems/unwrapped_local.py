"""The paper's Algorithm 2 on one device: ``UnwrappedADMM.solve``, which
drives ``solve_with_executor`` on a ``LocalExecutor`` (the Gram by K2a,
then the fused iteration K3 until Boyd's rule or ``max_iters``), with the
iteration history off, as a deployment runs it."""
from __future__ import annotations


def prepare(cfg: dict, inputs: dict, device, group=None):
    """A function of one request (any: every fit is the same) that runs
    one whole fit and returns {"x", "iters"}."""
    from repro_torch.core import prox
    from repro_torch.core.unwrapped import UnwrappedADMM

    solver = UnwrappedADMM(loss=getattr(prox, f"make_{cfg['loss']}")(),
                           tau=float(cfg["tau"]),
                           eps_rel=float(cfg["eps_rel"]),
                           eps_abs=float(cfg["eps_abs"]),
                           residency=cfg.get("residency"),
                           device=str(device))
    D, labels = inputs["D"], inputs["labels"]
    max_iters = int(cfg["max_iters"])

    def fit(request=None):
        res = solver.solve(D, labels, max_iters=max_iters)
        return {"x": res.x, "iters": int(res.iters)}
    return fit
