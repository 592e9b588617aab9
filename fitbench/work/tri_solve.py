"""The two triangular solves of an x-update on the factor: L and the
right-hand side read, x written; 2 n^2 operations."""


def count(m: int, n: int, cfg: dict):
    return 4 * n * n + 8 * n, 2 * n * n
