"""Serving layer: sufficient statistics as the unit of serving; port of
``repro/service``.

  stats     — SufficientStats: streaming update / merge / checkpoint
              + Cholesky rank-k up/downdate.
  registry  — @register_problem dispatch (the fit() entry point's backend)
              + stats-path solvers for quadratic data terms.
  batching  — multi-RHS / mu-grid coalescing over one cached factor.
  server    — FitServer: micro-batching request loop, LRU factor cache,
              observable cost counters.
  admission — token-bucket tenant quotas, bounded-queue load shedding,
              cold-solve circuit breaker.
  frontend  — FitFrontend: threaded TCP front end over the cluster
              framing; multi-tenant, deadline-aware, degrade-not-fail.
"""
from repro_torch.service.stats import (
    SufficientStats,
    chol_downdate,
    chol_update,
    combine_fingerprints,
    fingerprint_array,
)
from repro_torch.service.registry import (
    GRAM_SOLVERS,
    get_solver,
    methods,
    problems,
    register_problem,
    solve,
)
from repro_torch.service.batching import (
    batched_gram_solve,
    batched_quad_prox,
    lasso_mu_path,
    rhs_chunked,
)
from repro_torch.service.server import (
    FitRequest,
    FitResponse,
    FitServer,
    ServerCounters,
)
from repro_torch.service.admission import (
    Admission,
    AdmissionController,
    CircuitBreaker,
    TokenBucket,
)

__all__ = [
    "SufficientStats", "chol_downdate", "chol_update",
    "combine_fingerprints", "fingerprint_array", "GRAM_SOLVERS",
    "get_solver", "methods", "problems", "register_problem", "solve",
    "batched_gram_solve", "batched_quad_prox", "lasso_mu_path",
    "rhs_chunked", "FitRequest", "FitResponse", "FitServer",
    "ServerCounters", "Admission", "AdmissionController", "CircuitBreaker",
    "TokenBucket",
]

# FitFrontend / FitServiceClient import from repro_torch.service.frontend —
# deliberately NOT re-exported here: frontend pulls in the cluster
# transport, and in-process FitServer users should not pay that import.
