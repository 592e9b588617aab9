"""One fused ADMM iteration over D (K3): D, y, lam and the labels read, y'
and lam' written (20 m bytes), x read and d, w, v written (16 n); Dx and
three transposed products (8 m n) and the configuration's prox of each
row (``work/prox_<loss>.py``)."""
from fitbench import roofline


def count(m: int, n: int, cfg: dict, elt: int = 4):
    return (elt * m * n + 4 * 5 * m + 4 * 4 * n,
            8 * m * n + roofline.prox_flops(cfg) * m)
