"""Problem registry — one entry point for every solvable problem; port of
``repro/service/registry.py``.

Solvers self-register under ``(problem, method)`` with
:func:`register_problem`, and :func:`solve` is the single dispatch point
that ``repro_torch.core.fit.fit`` routes through. Two solver surfaces per
problem:

  * the *data path*  — ``fn(D, aux, **params) -> FitResult`` on
    node-stacked (N, m_i, n) tensors;
  * the *stats path* — for quadratic data terms (lasso / ridge / elastic
    net / NNLS), ``GRAM_SOLVERS[problem](G, c, **params)`` solves straight
    from the sufficient statistics. The data path of these problems takes
    (G, c) from ``engine.gram_stats`` on the data's device: one read of D,
    through K2b on the card.

Registered problems:
  lasso, logistic, svm, sparse_logistic   (the paper's solvers)
  ridge, elastic_net, huber, nnls         (quadratic / robust data terms)
  quantile, group_lasso, multinomial      (executor-backed)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import consensus as cons
from repro_torch.core import fasta as fasta_lib
from repro_torch.core import gram as gram_lib
from repro_torch.core import prox as prox_lib
from repro_torch.core.oracles import default_tau
from repro_torch.core.unwrapped import UnwrappedADMM
from repro_torch.engine import gram_stats

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RegisteredSolver:
    problem: str
    method: str
    fn: Callable[..., "FitResult"]
    gram_path: bool = False       # solvable from (G, c) sufficient stats


_REGISTRY: Dict[Tuple[str, str], RegisteredSolver] = {}

# problem -> fn(G, c, **params) -> (x, iters, objective_history|None)
GRAM_SOLVERS: Dict[str, Callable] = {}


def register_problem(problem: str, method: str = "transpose",
                     gram_path: bool = False, aliases: Tuple[str, ...] = ()):
    """Decorator registering ``fn(D, aux, **params) -> FitResult``."""

    def deco(fn):
        for meth in (method,) + tuple(aliases):
            _REGISTRY[(problem, meth)] = RegisteredSolver(
                problem=problem, method=meth, fn=fn, gram_path=gram_path)
        return fn

    return deco


def register_gram_solver(problem: str):
    def deco(fn):
        GRAM_SOLVERS[problem] = fn
        return fn

    return deco


def problems() -> Tuple[str, ...]:
    return tuple(sorted({p for p, _ in _REGISTRY}))


def methods(problem: str) -> Tuple[str, ...]:
    return tuple(sorted(m for p, m in _REGISTRY if p == problem))


def get_solver(problem: str, method: str) -> RegisteredSolver:
    spec = _REGISTRY.get((problem, method))
    if spec is None:
        raise ValueError(
            f"unsupported (problem={problem}, method={method}); "
            f"registered problems: {problems()}; "
            f"methods for {problem!r}: {methods(problem) or 'none'}")
    return spec


def solve(problem: str, D: Tensor, aux: Tensor, method: str = "transpose",
          **params) -> "FitResult":
    """The single dispatch point behind ``repro_torch.core.fit.fit``; D and
    aux are tensors on the device the solve runs on."""
    spec = get_solver(problem, method)
    if params.get("tau") is None and problem in (
            "lasso", "logistic", "svm", "sparse_logistic", "huber"):
        N, mi, n = D.shape
        base = {"sparse_logistic": "logistic", "huber": "svm"}.get(
            problem, problem)
        params["tau"] = default_tau(base, N * mi)
    return spec.fn(D, aux, **params)


def _result(x, iters, history, method, problem):
    from repro_torch.core.fit import FitResult
    return FitResult(x, int(iters), history, method, problem)


def _need_mu(mu, problem):
    if mu is None:
        raise ValueError(f"{problem} needs mu")
    return mu


# ---------------------------------------------------------------------------
# Stats-path solvers: x from (G, c) alone.
# ---------------------------------------------------------------------------

@register_gram_solver("ridge")
def ridge_from_stats(G: Tensor, c: Tensor, mu: float = 1.0, iters: int = 0,
                     **_):
    """min 0.5||Dx-b||^2 + mu/2||x||^2  ==  (G + mu I)^{-1} c, closed
    form."""
    n = G.shape[0]
    A = G + float(mu) * torch.eye(n, dtype=G.dtype, device=G.device)
    L = gram_lib.gram_factor(A)
    return gram_lib.gram_solve(L, c), 1, None


@register_gram_solver("lasso")
def lasso_from_stats(G: Tensor, c: Tensor, mu: float, iters: int = 2000,
                     x0: Optional[Tensor] = None, l2: float = 0.0, **_):
    # l2 is honoured: a lasso request with the elastic-net knob gets the
    # elastic-net solution (l2 = 0 is plain lasso)
    res = fasta_lib.transpose_reduction_lasso(G, c, mu, iters=iters, x0=x0,
                                              l2=l2)
    return res.x, res.iters, res.objective


@register_gram_solver("elastic_net")
def elastic_net_from_stats(G: Tensor, c: Tensor, mu: float, l2: float = 0.0,
                           iters: int = 2000, x0: Optional[Tensor] = None,
                           **_):
    """min mu|x| + l2/2||x||^2 + 0.5 x^T G x - x^T c: lasso's FASTA with
    the l2 term folded into the smooth part; l2 = 0 recovers lasso."""
    res = fasta_lib.transpose_reduction_lasso(G, c, mu, iters=iters, x0=x0,
                                              l2=l2)
    return res.x, res.iters, res.objective


@register_gram_solver("nnls")
def nnls_from_stats(G: Tensor, c: Tensor, iters: int = 2000,
                    x0: Optional[Tensor] = None, **_):
    """min_{x>=0} 0.5||Dx-b||^2 — projected gradient (FASTA, prox =
    clip)."""
    n = G.shape[0]
    if x0 is None:
        x0 = torch.zeros((n,), dtype=G.dtype, device=G.device)
    t0 = 1.0 / fasta_lib.power_lmax(G)
    solver = fasta_lib.Fasta(
        gradg=lambda x: G @ x - c,
        g=lambda x: 0.5 * torch.dot(x, G @ x) - torch.dot(x, c),
        proxJ=lambda z, t: prox_lib.project_nonneg(z),
        J=lambda x: torch.zeros((), dtype=x.dtype, device=x.device),
    )
    res = solver.run(x0.to(G.dtype), t0, iters)
    return res.x, res.iters, res.objective


# ---------------------------------------------------------------------------
# Data-path solvers.
# ---------------------------------------------------------------------------

def _flatten(D: Tensor):
    N, mi, n = D.shape
    return D.reshape(N * mi, n), N * mi, n


def _admm(loss, D, **kw) -> UnwrappedADMM:
    return UnwrappedADMM(loss=loss, device=str(D.device), **kw)


@register_problem("lasso", "transpose", gram_path=True, aliases=("fasta",))
def _lasso_transpose(D, aux, mu=None, iters=500, x0=None, l2: float = 0.0,
                     **_):
    mu = _need_mu(mu, "lasso")
    # section 4: direct transpose reduction (K2b on the card), then the
    # single-node FASTA on the (n, n) Gram
    Dflat, m, n = _flatten(D)
    G, c = gram_stats(Dflat, aux.reshape(m))
    x, it, hist = lasso_from_stats(G, c, mu, iters=iters, x0=x0, l2=l2)
    return _result(x, it, hist, "transpose", "lasso")


@register_problem("lasso", "consensus")
def _lasso_consensus(D, aux, mu=None, tau=None, iters=500, **_):
    mu = _need_mu(mu, "lasso")
    r = cons.ConsensusLasso(mu=mu, tau=tau).run(D, aux, iters)
    return _result(r.z, r.iters, r.history.objective, "consensus", "lasso")


@register_problem("logistic", "transpose")
def _logistic_transpose(D, aux, tau=None, iters=500, record=True, x0=None,
                        **_):
    r = _admm(prox_lib.make_logistic(), D, tau=tau).run(
        D, aux, iters, x0=x0, record=record)
    hist = r.history.objective if r.history else None
    return _result(r.x, r.iters, hist, "transpose", "logistic")


@register_problem("logistic", "consensus")
def _logistic_consensus(D, aux, tau=None, iters=500, **_):
    r = cons.ConsensusLogistic(tau=tau).run(D, aux, iters)
    return _result(r.z, r.iters, r.history.objective, "consensus",
                   "logistic")


@register_problem("sparse_logistic", "transpose")
def _sparse_logistic_transpose(D, aux, mu=None, tau=None, iters=500,
                               record=True, x0=None, **_):
    mu = _need_mu(mu, "sparse_logistic")
    # section 7 stacking [I; D]: the identity block rides on a virtual node
    Dflat, m, n = _flatten(D)
    D_hat = torch.cat([torch.eye(n, dtype=D.dtype, device=D.device),
                       Dflat], 0)[None]
    sp = prox_lib.StackedProx(
        blocks=(prox_lib.make_l1(mu), prox_lib.make_logistic()),
        sizes=(n, m))
    aux_hat = torch.cat([torch.zeros((n,), dtype=aux.dtype,
                                     device=aux.device),
                         aux.reshape(m)])[None]
    r = _admm(sp.as_loss("sparse_logistic"), D, tau=tau).run(
        D_hat, aux_hat, iters, x0=x0, record=record)
    hist = r.history.objective if r.history else None
    return _result(r.x, r.iters, hist, "transpose", "sparse_logistic")


@register_problem("sparse_logistic", "consensus")
def _sparse_logistic_consensus(D, aux, mu=None, tau=None, iters=500, **_):
    mu = _need_mu(mu, "sparse_logistic")
    r = cons.ConsensusLogistic(mu=mu, tau=tau).run(D, aux, iters)
    return _result(r.z, r.iters, r.history.objective, "consensus",
                   "sparse_logistic")


@register_problem("svm", "transpose")
def _svm_transpose(D, aux, C=1.0, tau=None, iters=500, record=True, x0=None,
                   **_):
    r = _admm(prox_lib.make_hinge(C), D, tau=tau, rho=1.0).run(
        D, aux, iters, x0=x0, record=record)
    hist = r.history.objective if r.history else None
    return _result(r.x, r.iters, hist, "transpose", "svm")


@register_problem("svm", "consensus")
def _svm_consensus(D, aux, C=1.0, tau=None, iters=500, **_):
    r = cons.ConsensusSVM(C=C, tau=tau).run(D, aux, iters)
    return _result(r.z, r.iters, r.history.objective, "consensus", "svm")


@register_problem("ridge", "transpose", gram_path=True, aliases=("fasta",))
def _ridge_transpose(D, aux, mu=None, **_):
    mu = 1.0 if mu is None else mu
    Dflat, m, n = _flatten(D)
    G, c = gram_stats(Dflat, aux.reshape(m))
    x, it, hist = ridge_from_stats(G, c, mu=mu)
    return _result(x, it, hist, "transpose", "ridge")


@register_problem("elastic_net", "transpose", gram_path=True,
                  aliases=("fasta",))
def _elastic_net_transpose(D, aux, mu=None, l2: float = 0.0, iters=500,
                           x0=None, **_):
    mu = _need_mu(mu, "elastic_net")
    Dflat, m, n = _flatten(D)
    G, c = gram_stats(Dflat, aux.reshape(m))
    x, it, hist = elastic_net_from_stats(G, c, mu=mu, l2=l2, iters=iters,
                                         x0=x0)
    return _result(x, it, hist, "transpose", "elastic_net")


@register_problem("nnls", "transpose", gram_path=True, aliases=("fasta",))
def _nnls_transpose(D, aux, iters=500, x0=None, **_):
    Dflat, m, n = _flatten(D)
    G, c = gram_stats(Dflat, aux.reshape(m))
    x, it, hist = nnls_from_stats(G, c, iters=iters, x0=x0)
    return _result(x, it, hist, "transpose", "nnls")


@register_problem("huber", "transpose")
def _huber_transpose(D, aux, delta: float = 1.0, tau=None, iters=500,
                     record=True, x0=None, **_):
    """Robust regression min sum h_delta(Dx - b): unwrapped ADMM, huber
    prox (no kernel kind: the engine's torch body)."""
    r = _admm(prox_lib.make_huber(delta), D, tau=tau).run(
        D, aux, iters, x0=x0, record=record)
    hist = r.history.objective if r.history else None
    return _result(r.x, r.iters, hist, "transpose", "huber")


@register_problem("quantile", "transpose")
def _quantile_transpose(D, aux, q: float = 0.5, tau=None, iters=500,
                        record=True, x0=None, **_):
    """Quantile regression min sum rho_q(Dx - b): pinball prox, the same
    transpose-reduction loop (K3's quantile kind on the card)."""
    r = _admm(prox_lib.make_quantile(q), D,
              tau=1.0 if tau is None else tau).run(
        D, aux, iters, x0=x0, record=record)
    hist = r.history.objective if r.history else None
    return _result(r.x, r.iters, hist, "transpose", "quantile")


@register_problem("group_lasso", "transpose")
def _group_lasso_transpose(D, aux, mu=None, groups=None, tau=None,
                           iters=500, record=True, x0=None, **_):
    """Group lasso min 0.5||Dx-b||^2 + mu sum_g ||x_g||: least-squares
    data term plus an x-space group penalty, solved by the composite
    prox-gradient x-update of ``solve_with_executor``."""
    mu = _need_mu(mu, "group_lasso")
    from repro_torch.exec import make_group_lasso_reg
    n = D.shape[-1]
    g = torch.arange(n) // 4 if groups is None else \
        torch.as_tensor(groups).cpu()
    reg = make_group_lasso_reg(float(mu), g, int(g[-1]) + 1)
    r = _admm(prox_lib.make_least_squares(), D,
              tau=1.0 if tau is None else tau).solve(
        D, aux, max_iters=iters, x0=x0, record=record, reg=reg)
    hist = r.history.objective if r.history else None
    return _result(r.x, r.iters, hist, "transpose", "group_lasso")


@register_problem("multinomial", "transpose")
def _multinomial_transpose(D, aux, classes: int = 3, tau=None, iters=500,
                           record=True, x0=None, **_):
    """Multinomial logistic over K classes: (m, K) splitting iterates
    through the same multi-RHS Gram machinery; x comes back (n, K)."""
    r = _admm(prox_lib.make_multinomial(int(classes)), D,
              tau=0.5 if tau is None else tau).solve(
        D, aux, max_iters=iters, x0=x0, record=record)
    hist = r.history.objective if r.history else None
    return _result(r.x, r.iters, hist, "transpose", "multinomial")
