"""Independent high-precision reference solvers (test/benchmark oracles);
port of ``repro/core/oracles.py``, which is numpy apart from its ``Array``
alias, so the port keeps its own copy.

These deliberately use *different algorithms* than the ADMM solvers so that
agreement is meaningful: full-data Newton for logistic, dual coordinate
descent (LIBSVM-style) for SVM, and KKT certificates for lasso.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Array = torch.Tensor


def newton_logistic(D2: np.ndarray, labels: np.ndarray, iters: int = 60,
                    ridge: float = 0.0) -> np.ndarray:
    """Full-batch damped Newton on sum softplus(-l * Dx) (+ ridge/2 ||x||^2)."""
    D2 = np.asarray(D2, np.float64)
    l = np.asarray(labels, np.float64).ravel()
    m, n = D2.shape
    x = np.zeros(n)
    for _ in range(iters):
        z = D2 @ x
        s = 0.5 * (1.0 + np.tanh(-0.5 * l * z))  # stable sigmoid(-l z)
        g = D2.T @ (-l * s) + ridge * x
        H = (D2 * (s * (1 - s))[:, None]).T @ D2 + (ridge + 1e-10) * np.eye(n)
        step = np.linalg.solve(H, g)
        # Damping for global safety.
        t, z0 = 1.0, np.sum(np.logaddexp(0, -l * z)) + 0.5 * ridge * x @ x
        for _ in range(30):
            xn = x - t * step
            fn = np.sum(np.logaddexp(0, -l * (D2 @ xn))) + 0.5 * ridge * xn @ xn
            if fn <= z0 - 1e-4 * t * (g @ step):
                break
            t *= 0.5
        x = x - t * step
        if np.linalg.norm(t * step) < 1e-12:
            break
    return x


def logistic_objective(D2, labels, x) -> float:
    z = np.asarray(D2, np.float64) @ np.asarray(x, np.float64)
    l = np.asarray(labels, np.float64).ravel()
    return float(np.sum(np.logaddexp(0.0, -l * z)))


def svm_dual_cd(D2: np.ndarray, labels: np.ndarray, C: float,
                passes: int = 400, seed: int = 0) -> np.ndarray:
    """LIBSVM-style dual coordinate descent for 0.5||w||^2 + C h(Dw).

    Dual: min_{0<=alpha<=C} 0.5||D^T L alpha||^2 - alpha^T 1;  w = D^T L alpha.
    """
    D2 = np.asarray(D2, np.float64)
    l = np.asarray(labels, np.float64).ravel()
    m, n = D2.shape
    rng = np.random.default_rng(seed)
    alpha = np.zeros(m)
    w = np.zeros(n)
    qii = np.einsum("ij,ij->i", D2, D2)
    for _ in range(passes):
        order = rng.permutation(m)
        max_pg = 0.0
        for i in order:
            g = l[i] * (D2[i] @ w) - 1.0
            pg = min(g, 0.0) if alpha[i] <= 0 else (max(g, 0.0) if alpha[i] >= C else g)
            max_pg = max(max_pg, abs(pg))
            if qii[i] <= 0:
                continue
            a_new = min(max(alpha[i] - g / qii[i], 0.0), C)
            if a_new != alpha[i]:
                w += (a_new - alpha[i]) * l[i] * D2[i]
                alpha[i] = a_new
        if max_pg < 1e-10:
            break
    return w


def svm_objective(D2, labels, w, C: float) -> float:
    D2 = np.asarray(D2, np.float64)
    l = np.asarray(labels, np.float64).ravel()
    margins = 1.0 - l * (D2 @ np.asarray(w, np.float64))
    return float(0.5 * np.dot(w, w) + C * np.sum(np.maximum(margins, 0.0)))


def lasso_objective(D2, b, x, mu: float) -> float:
    D2 = np.asarray(D2, np.float64)
    r = D2 @ np.asarray(x, np.float64) - np.asarray(b, np.float64).ravel()
    return float(0.5 * r @ r + mu * np.sum(np.abs(x)))


def lasso_kkt_gap(D2, b, x, mu: float) -> Tuple[float, float]:
    """KKT certificate for lasso: returns (inf-norm violation, support err).

    Optimality: ||D^T(Dx-b)||_inf <= mu, and D_j^T(Dx-b) = -mu sign(x_j) on
    the support.
    """
    D2 = np.asarray(D2, np.float64)
    x = np.asarray(x, np.float64)
    r = D2 @ x - np.asarray(b, np.float64).ravel()
    corr = D2.T @ r
    viol = max(float(np.max(np.abs(corr)) - mu), 0.0)
    sup = np.abs(x) > 1e-7
    sup_err = float(np.max(np.abs(corr[sup] + mu * np.sign(x[sup])))) if sup.any() else 0.0
    return viol, sup_err


def default_tau(problem: str, m: int) -> float:
    """Stepsize defaults, following the paper's §9 tuning protocol (tune on a
    reference instance, then scale).

    For *unwrapped* ADMM the y-update is a per-coordinate prox whose scale
    does not depend on m, so tau is m-independent for logistic/SVM
    (calibrated in the JAX package's benchmarks/tau_calibration.py: tau=0.1 converges in ~50
    iters at m=1e3 and m=1e5 alike). The §7-stacked lasso couples x- and
    y-blocks through a Gram with spectrum O(m), so there tau scales with m —
    the same proportional-to-m rule the paper uses for consensus.
    """
    if problem == "logistic":
        return 0.1
    if problem == "svm":
        return 0.5
    if problem == "lasso":
        return 1e-2 * m
    raise ValueError(problem)
