"""repro_torch.service — the problem registry behind ``fit()`` (port of
``repro/service/registry.py``) and the sufficient statistics it serves
from (``stats.py``). The serving layer proper (batching, server,
admission, frontend) is ROADMAP item 10."""
from repro_torch.service.registry import (
    GRAM_SOLVERS,
    get_solver,
    methods,
    problems,
    register_problem,
    solve,
)
from repro_torch.service.stats import (
    SufficientStats,
    chol_downdate,
    chol_update,
    combine_fingerprints,
    fingerprint_array,
)

__all__ = ["GRAM_SOLVERS", "SufficientStats", "chol_downdate",
           "chol_update", "combine_fingerprints", "fingerprint_array",
           "get_solver", "methods", "problems", "register_problem", "solve"]
