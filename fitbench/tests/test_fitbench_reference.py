"""The plain reference at a tiny size against independent float64
solutions: the logistic prox against its optimality condition, the
logistic ADMM's fixed point against Newton's method on the logistic
likelihood, and the judge's numbers against their definitions."""
import numpy as np
import pytest
import torch

from fitbench import manifest
from fitbench.reference import logistic_admm


def test_logistic_prox_is_the_root():
    g = torch.Generator().manual_seed(0)
    z = 30 * torch.randn(100_000, generator=g, dtype=torch.float64)
    lab = torch.sign(torch.randn(100_000, generator=g, dtype=torch.float64))
    y = logistic_admm.prox_logistic(z, lab, 10.0)
    dphi = -lab * torch.sigmoid(-lab * y) + (y - z) / 10.0
    assert float(dphi.abs().max()) < 1e-12


def _newton_logistic(D, lab, iters=50):
    """The minimizer of sum log(1 + exp(-l D x)) by Newton's method."""
    x = np.zeros(D.shape[1])
    for _ in range(iters):
        z = lab * (D @ x)
        s = 0.5 * (1.0 - np.tanh(0.5 * z))          # sigmoid(-z)
        grad = -D.T @ (lab * s)
        H = D.T @ (D * (s * (1 - s))[:, None])
        x = x - np.linalg.solve(H, grad)
    return x


def test_logistic_reference_reaches_the_likelihood_minimizer():
    cfg = dict(manifest.data_file("configs", "star_catalog"))
    cfg.update({"rows_per_node": 3000, "base_features": 3,
                "max_iters": 4000, "eps_rel": 1e-13, "eps_abs": 1e-13})
    inputs = manifest.module("data", "star_catalog").make(cfg, 5, "cpu")
    ref = logistic_admm.solve(cfg, inputs, "cpu")
    D = inputs["D"].reshape(-1, inputs["D"].shape[-1]).double().numpy()
    lab = inputs["labels"].reshape(-1).double().numpy()
    x_nt = _newton_logistic(D, lab)
    err = np.linalg.norm(ref["x"].numpy() - x_nt) / np.linalg.norm(x_nt)
    assert err < 1e-6, err


def test_judge_against_its_definitions():
    cfg = dict(manifest.data_file("configs", "star_catalog"))
    cfg.update({"rows_per_node": 2000, "base_features": 3, "max_iters": 20})
    inputs = manifest.module("data", "star_catalog").make(cfg, 9, "cpu")
    ref = logistic_admm.solve(cfg, inputs, "cpu")
    D = inputs["D"].reshape(-1, inputs["D"].shape[-1]).double()
    x = ref["x"] + 1e-3 * torch.randn(ref["x"].shape[0],
                                      generator=torch.Generator()
                                      .manual_seed(1), dtype=torch.float64)
    got = logistic_admm.judge(cfg, ref, [{"x": x.float(), "iters": 17}])[0]
    xf = x.float().double()
    margins = torch.linalg.norm(D @ (xf - ref["x"])) / \
        torch.linalg.norm(D @ ref["x"])
    assert got["fit_err"] == pytest.approx(float(margins), rel=1e-9)
    assert got["x_err"] == pytest.approx(
        float(torch.linalg.norm(xf - ref["x"]) / torch.linalg.norm(ref["x"])),
        rel=1e-12)
    assert got["iters_gap"] == 3


def test_judge_reads_nan_as_failing():
    ref = {"x": torch.ones(3, dtype=torch.float64),
           "G": torch.eye(3, dtype=torch.float64), "iters": 5}
    bad = [{"x": torch.tensor([1.0, float("nan"), 1.0]), "iters": 5}]
    got = logistic_admm.judge({}, ref, bad)[0]
    assert not got["x_err"] <= 1.0 and not got["fit_err"] <= 1.0
