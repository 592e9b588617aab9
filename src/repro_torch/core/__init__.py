"""The paper's contribution: unwrapped ADMM with transpose reduction
(PyTorch port of ``repro.core``; the dense single-device solve)."""
from repro_torch.core.gram import (
    gram_and_rhs_chunked,
    gram_chunked,
    gram_factor,
    gram_rhs,
    gram_solve,
)
from repro_torch.core.prox import (
    ProxLoss,
    loss_from_spec,
    make_hinge,
    make_l1,
    make_least_squares,
    make_logistic,
    make_quantile,
    soft_threshold,
)
from repro_torch.core.unwrapped import ADMMResult, UnwrappedADMM

__all__ = [
    "ADMMResult", "ProxLoss", "UnwrappedADMM", "gram_and_rhs_chunked",
    "gram_chunked", "gram_factor", "gram_rhs", "gram_solve",
    "loss_from_spec", "make_hinge", "make_l1", "make_least_squares",
    "make_logistic", "make_quantile", "soft_threshold",
]
