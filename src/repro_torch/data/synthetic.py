"""Synthetic GLM data generators — paper sections 10.1 and 10.2; port of
``repro/data/synthetic.py`` (``lasso_problem``, ``classification_problem``
and ``star_catalog_problem``).

Both emit the node-stacked layout (N, m_i, n) used by the solvers, drawn
from an explicit ``torch.Generator`` on the chosen device, and fill D in
row blocks into one preallocated tensor, so peak memory stays near
bytes(D) at full size. The numbers differ from ``jax.random``'s for the
same seed; the parity tests take their arrays from the JAX generators.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

BLOCK_ROWS = 1 << 18


class LassoProblem(NamedTuple):
    D: torch.Tensor          # (N, m_i, n)
    b: torch.Tensor          # (N, m_i)
    x_true: torch.Tensor     # (n,)
    mu: torch.Tensor         # scalar: the paper's 10% rule


class ClassifProblem(NamedTuple):
    D: torch.Tensor          # (N, m_i, n)
    labels: torch.Tensor     # (N, m_i) in {-1, +1}


def _generators(seed: int, device: torch.device):
    """(bulk generator on ``device``, small-draw generator on the CPU):
    the few scalars and n-vectors come from the CPU generator, so they
    are the same on every device."""
    bulk = torch.Generator(device=device)
    bulk.manual_seed(int(seed))
    small = torch.Generator()
    small.manual_seed(int(seed) + 1)
    return bulk, small


def _hetero_shift(gen: torch.Generator, N: int, scale: float
                  ) -> torch.Tensor:
    """Paper: 'one random Gaussian scalar for each node, added to D_i';
    (N, 1, 1), from the CPU generator."""
    return scale * torch.randn((N, 1, 1), generator=gen)


def lasso_problem(seed: int, N: int, m_per_node: int, n: int,
                  active: int = 10, heterogeneity: float = 0.0,
                  noise_sigma: float = 1.0, dtype=torch.float32,
                  device="cuda") -> LassoProblem:
    """Boyd-style lasso test problem (paper section 10.1 'Lasso problems').

    D random Gaussian (plus one Gaussian shift per node when
    ``heterogeneity`` is set); x_true has ``active`` entries of +-1;
    b = D x_true + sigma eta; mu = 10% of mu_max = ||D^T b||_inf, with
    D^T b accumulated in f32 as the reference does."""
    dev = resolve_device(device)
    gen, small = _generators(seed, dev)
    shift = _hetero_shift(small, N, heterogeneity) if heterogeneity \
        else None
    idx = torch.randperm(n, generator=small)[:active]
    signs = torch.sign(torch.randn(idx.numel(), generator=small))
    x_true = torch.zeros(n, dtype=dtype)
    x_true[idx] = signs.to(dtype)
    x_true = x_true.to(dev)
    D = torch.empty((N, m_per_node, n), dtype=dtype, device=dev)
    b = torch.empty((N, m_per_node), dtype=dtype, device=dev)
    dtb = torch.zeros(n, dtype=torch.float32, device=dev)
    for i in range(N):
        for s in range(0, m_per_node, BLOCK_ROWS):
            e = min(m_per_node, s + BLOCK_ROWS)
            blk = torch.randn((e - s, n), generator=gen, dtype=dtype,
                              device=dev)
            if shift is not None:
                blk += float(shift[i])
            D[i, s:e] = blk
            b[i, s:e] = blk @ x_true + noise_sigma * torch.randn(
                e - s, generator=gen, dtype=dtype, device=dev)
            dtb += blk.float().T @ b[i, s:e].float()
    mu = 0.1 * torch.max(torch.abs(dtb))
    return LassoProblem(D, b, x_true, mu)


def _balanced_labels(N, m_per_node, dtype, device, gen):
    """Per node: m - m//2 labels -1 and m//2 labels +1, shuffled."""
    m_half = m_per_node // 2
    base = torch.cat([-torch.ones(m_per_node - m_half, dtype=dtype),
                      torch.ones(m_half, dtype=dtype)]).to(device)
    labels = torch.empty((N, m_per_node), dtype=dtype, device=device)
    for i in range(N):
        labels[i] = base[torch.randperm(m_per_node, generator=gen,
                                        device=device)]
    return labels


def classification_problem(seed: int, N: int, m_per_node: int, n: int,
                           informative: int = 5, mean_shift: float = 1.0,
                           heterogeneity: float = 0.0,
                           dtype=torch.float32,
                           device="cuda") -> ClassifProblem:
    """Paper section 10.1 'Classification problems'.

    Two Gaussian classes; class +1 has mean ``mean_shift`` in its first
    ``informative`` columns (the classes are not separable); rows of the
    two classes are interleaved evenly per node; an optional per-node
    scalar shift makes the nodes heterogeneous. The reference shuffles the
    rows of D with their labels; here the labels are shuffled first and
    each row is drawn for its label, which is the same distribution and
    needs no second copy of D."""
    dev = resolve_device(device)
    gen, small = _generators(seed, dev)
    labels = _balanced_labels(N, m_per_node, dtype, dev, gen)
    node_shift = heterogeneity * torch.randn(N, generator=small)
    D = torch.empty((N, m_per_node, n), dtype=dtype, device=dev)
    for i in range(N):
        for s in range(0, m_per_node, BLOCK_ROWS):
            e = min(m_per_node, s + BLOCK_ROWS)
            blk = torch.randn((e - s, n), generator=gen, dtype=dtype,
                              device=dev)
            pos = (labels[i, s:e] > 0).to(dtype)[:, None]
            blk[:, :informative] += mean_shift * pos
            if heterogeneity:
                blk += float(node_shift[i])
            D[i, s:e] = blk
    return ClassifProblem(D, labels)


def star_catalog_problem(seed: int, N: int, m_per_node: int,
                         base_features: int = 17, dtype=torch.float32,
                         device="cuda") -> ClassifProblem:
    """GSC-II analogue (paper section 10.2): 17 base measurements, a
    17 x 17 grid of second-order products and a bias = 307 features, the
    paper's width.

    Base features are drawn from a node-dependent Gaussian (sky-survey data
    is not iid across shards); the label is a noisy sparse logistic teacher
    over all features; features are normalized by their standard deviation
    over all rows.

    Two faults of the reference are fixed here (ROADMAP section 3). The
    reference squares one set of 17 measurements, so its columns (i, j)
    and (j, i) are equal: the Gram is singular and the reference logistic
    solve returns NaN. Here product
    (i, j) multiplies measurement i of one epoch by measurement j of a
    second, independent epoch, which keeps the width and makes the 289
    products distinct. And the reference divides the bias column by its
    zero spread floored at 1e-6, making it 1e6; here a column with no
    spread is left as it is.
    """
    dev = resolve_device(device)
    gen, small = _generators(seed, dev)
    nb = base_features
    n = nb + nb * nb + 1
    node_shift = 0.5 * torch.randn(N, generator=small)
    w = torch.randn(n, generator=small) * (
        torch.rand(n, generator=small) < 0.1).to(torch.float32)
    D = torch.empty((N, m_per_node, n), dtype=dtype, device=dev)
    s1 = torch.zeros(n, dtype=torch.float64, device=dev)
    s2 = torch.zeros(n, dtype=torch.float64, device=dev)
    for i in range(N):
        for s in range(0, m_per_node, BLOCK_ROWS):
            e = min(m_per_node, s + BLOCK_ROWS)
            b = e - s
            a = torch.randn((b, nb), generator=gen, dtype=dtype,
                            device=dev) + float(node_shift[i])
            a2 = torch.randn((b, nb), generator=gen, dtype=dtype,
                             device=dev) + float(node_shift[i])
            blk = D[i, s:e]
            blk[:, :nb] = a
            blk[:, nb:nb + nb * nb] = (a[:, :, None]
                                       * a2[:, None, :]).reshape(b, nb * nb)
            blk[:, -1] = 1.0
            s1 += blk.sum(0, dtype=torch.float64)
            s2 += (blk.double() ** 2).sum(0)
    total = N * m_per_node
    var = torch.clamp(s2 / total - (s1 / total) ** 2, min=0.0)
    std = torch.sqrt(var)
    scale = torch.where(std > 1e-6, 1.0 / std, torch.ones_like(std)).to(dtype)
    w = w.to(device=dev, dtype=dtype)
    labels = torch.empty((N, m_per_node), dtype=dtype, device=dev)
    for i in range(N):
        for s in range(0, m_per_node, BLOCK_ROWS):
            e = min(m_per_node, s + BLOCK_ROWS)
            blk = D[i, s:e]
            blk *= scale
            noise = 0.5 * torch.randn(e - s, generator=gen, dtype=dtype,
                                      device=dev)
            lab = torch.sign(blk @ w + noise)
            labels[i, s:e] = torch.where(lab == 0, torch.ones_like(lab), lab)
    return ClassifProblem(D, labels)
