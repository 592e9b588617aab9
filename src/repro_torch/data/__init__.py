"""Data for the solvers: the synthetic generators (``synthetic``, dense),
the padded block-CSR container with its sparse generators (``sparse``)
and the host row-block store of the out-of-core path (``store``)."""
from repro_torch.data.sparse import (
    BlockCSR,
    SparseClassifProblem,
    SparseLassoProblem,
    random_block_csr,
    sparse_classification_problem,
    sparse_lasso_problem,
)
from repro_torch.data.store import (
    ZERO_FINGERPRINT,
    ShardedMatrixStore,
    combine_fingerprints,
    fingerprint_array,
)

__all__ = [
    "BlockCSR", "ShardedMatrixStore", "SparseClassifProblem",
    "SparseLassoProblem", "ZERO_FINGERPRINT", "combine_fingerprints",
    "fingerprint_array", "random_block_csr",
    "sparse_classification_problem", "sparse_lasso_problem",
]
