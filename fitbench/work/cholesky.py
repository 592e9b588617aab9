"""The factor of the n x n Gram: G read, L written; n^3 / 3 operations."""


def count(m: int, n: int, cfg: dict):
    return 8 * n * n, n ** 3 / 3
