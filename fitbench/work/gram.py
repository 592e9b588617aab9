"""G = D^T D in one pass (K2a): one read of D, G written; m n^2 operations
(the symmetric half, a multiply and an add each)."""


def count(m: int, n: int, cfg: dict, elt: int = 4):
    return elt * m * n + 4 * n * n, m * n * n
