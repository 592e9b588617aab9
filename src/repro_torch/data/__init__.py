"""Data for the solvers: the synthetic generators (``synthetic``, dense)
and the padded block-CSR container with its sparse generators
(``sparse``)."""
from repro_torch.data.sparse import (
    BlockCSR,
    SparseClassifProblem,
    SparseLassoProblem,
    random_block_csr,
    sparse_classification_problem,
    sparse_lasso_problem,
)

__all__ = [
    "BlockCSR", "SparseClassifProblem", "SparseLassoProblem",
    "random_block_csr", "sparse_classification_problem",
    "sparse_lasso_problem",
]
