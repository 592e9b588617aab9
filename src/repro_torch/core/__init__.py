"""The paper's contribution: unwrapped ADMM with transpose reduction
(PyTorch port of ``repro.core``): the single-device solve on dense or
block-CSR data, the solve over the ranks of a process group, the
column-split dual lasso, FASTA on the cached Gram, the consensus baseline
and ``fit()``."""
from repro_torch.core.column_split import ColumnSplitResult, lasso_column_split
from repro_torch.core.consensus import (
    ConsensusLasso,
    ConsensusLogistic,
    ConsensusSVM,
)
from repro_torch.core.distributed import DistributedUnwrappedADMM
from repro_torch.core.fasta import (
    Fasta,
    lasso_mu_max,
    transpose_reduction_lasso,
)
from repro_torch.core.fit import FitResult, fit
from repro_torch.core.gram import (
    gram_and_rhs_chunked,
    gram_chunked,
    gram_factor,
    gram_rhs,
    gram_solve,
)
from repro_torch.core.prox import (
    ProxLoss,
    StackedProx,
    loss_from_spec,
    make_hinge,
    make_huber,
    make_l1,
    make_least_squares,
    make_linf_ball,
    make_logistic,
    make_multinomial,
    make_quantile,
    make_shifted_least_squares,
    soft_threshold,
)
from repro_torch.core.unwrapped import (
    ADMMResult,
    UnwrappedADMM,
    sparse_unwrapped_lasso_matrices,
)

__all__ = [
    "ADMMResult", "ColumnSplitResult", "ConsensusLasso",
    "ConsensusLogistic", "ConsensusSVM", "DistributedUnwrappedADMM", "Fasta",
    "FitResult", "ProxLoss",
    "StackedProx", "UnwrappedADMM", "fit", "gram_and_rhs_chunked",
    "gram_chunked", "gram_factor", "gram_rhs", "gram_solve",
    "lasso_column_split", "lasso_mu_max", "loss_from_spec", "make_hinge",
    "make_huber", "make_l1", "make_least_squares", "make_linf_ball",
    "make_logistic", "make_multinomial", "make_quantile",
    "make_shifted_least_squares", "soft_threshold",
    "sparse_unwrapped_lasso_matrices", "transpose_reduction_lasso",
]
