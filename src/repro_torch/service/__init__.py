"""repro_torch.service — the problem registry behind ``fit()``; port of
``repro/service/registry.py``. The serving layer (stats, batching,
server, admission, frontend) is ROADMAP item 10."""
from repro_torch.service.registry import (
    GRAM_SOLVERS,
    get_solver,
    methods,
    problems,
    register_problem,
    solve,
)

__all__ = ["GRAM_SOLVERS", "get_solver", "methods", "problems",
           "register_problem", "solve"]
