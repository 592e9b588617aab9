"""The SolveExecutor contract and the ONE unwrapped-ADMM solve driver;
port of ``repro/exec/base.py``.

Every topology produces the same three n-sized reductions d = D^T(y'-lam'),
w = D^T(y'-y), v = D^T lam' plus four scalars; everything above that line
— the x-update, Boyd's stopping rule, warm starts and history assembly —
is topology-independent and lives here once (DESIGN.md section 14).

A :class:`SolveExecutor` owns three primitives: ``setup()`` (stage the
data, return G = D^T D), ``init(x0)`` (establish (y, lam), return the
warm-start d) and ``sweep(x, k)`` (one fused pass, returning a
:class:`~repro_torch.engine.streaming.SweepResult`).

Small hooks split checkpoint ownership: the backend owns the SHAPES of
its state, the driver the CADENCE (every ``checkpoint_every``
iterations through :class:`~repro_torch.checkpoint.CheckpointManager`) and
the resume validation. Not ported yet: observability (``repro.obs`` may
not be imported; ROADMAP item 10); asking for it raises.
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import gram as gram_lib
from repro_torch.engine.streaming import SweepResult

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# composite x-update: argmin g(x) + tau/2 (x'Gx - 2 d'x), prox-gradient
# ---------------------------------------------------------------------------

def power_lmax(G: Tensor) -> Tensor:
    """Largest eigenvalue of G by 30 power iterations — the inner
    prox-gradient stepsize for composite x-updates."""
    n = G.shape[0]
    v = torch.ones((n,), dtype=G.dtype, device=G.device) / math.sqrt(n)
    for _ in range(30):
        w = G @ v
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    return torch.dot(v, G @ v)


def composite_x_update(G: Tensor, lmax: Tensor, d: Tensor, x_warm: Tensor,
                       tau: float, prox: Callable[[Tensor, Tensor], Tensor],
                       inner_iters: int = 25) -> Tensor:
    """Warm-started proximal gradient on the cached Gram: minimizes
    g(x) + tau/2 (x'Gx - 2 d'x) where ``prox(z, step)`` is the prox of
    ``step * g``."""
    step = 1.0 / (tau * lmax)
    x = x_warm
    for _ in range(inner_iters):
        grad = tau * (G @ x - d)
        x = prox(x - step * grad, step)
    return x


@dataclasses.dataclass(frozen=True)
class Regularizer:
    """A separable penalty g(x) on the SOLUTION (not on y = Dx): the
    x-update becomes the composite prox-gradient above instead of a
    Cholesky solve. ``prox(z, step)`` is the prox of ``step * g``."""

    name: str
    value: Callable[[Tensor], Tensor]
    prox: Callable[[Tensor, Tensor], Tensor]
    inner_iters: int = 25


def make_l1_reg(mu: float, inner_iters: int = 25) -> Regularizer:
    from repro_torch.core.prox import soft_threshold
    return Regularizer("l1", lambda x: mu * torch.sum(torch.abs(x)),
                       lambda z, step: soft_threshold(z, step * mu),
                       inner_iters)


def make_group_lasso_reg(mu: float, groups, num_groups: int,
                         inner_iters: int = 40) -> Regularizer:
    """Group-lasso penalty mu * sum_g ||x_g||_2 over the coordinate
    partition ``groups`` (ints mapping coordinate -> group id). Group sums
    are a product with the one-hot (n x G) matrix: a fixed order, where
    the reference's ``segment_sum`` would become float atomics."""
    from repro_torch.core.prox import group_onehot, group_soft_threshold
    g = torch.as_tensor(groups).long()

    def value(x):
        sq = (x * x) @ group_onehot(g, num_groups, x.dtype, x.device)
        return mu * torch.sum(torch.sqrt(sq))

    return Regularizer(
        "group_lasso", value,
        lambda z, step: group_soft_threshold(z, step * mu, g.to(z.device),
                                             num_groups),
        inner_iters)


# ---------------------------------------------------------------------------
# the executor contract
# ---------------------------------------------------------------------------

class SolveExecutor(abc.ABC):
    """One solve topology reduced to its three primitives. Instances are
    single-solve: the driver owns the iterate state between ``init`` and
    the last ``sweep``."""

    name: str = "?"                  # executor label
    backend: str = "?"               # resolved engine backend
    checkpoint_kind: str = "solve"   # checkpoint `extra["kind"]` tag
    kind_label: str = "executor"     # human label in restore errors
    restore_fallback: bool = False   # CheckpointManager fallback scan
    writes_checkpoint: bool = True   # False: another rank writes them
    error_cls = ValueError           # restore-refusal exception type
    status: str = "ok"               # backends may set "degraded"

    m: int
    n: int
    ycols: int = 1                   # columns of y / x (multinomial: K)
    acc = torch.float32              # accumulation dtype of x/d
    device = torch.device("cpu")     # where x and d live

    @abc.abstractmethod
    def setup(self) -> Tensor:
        """Stage the data; return the Gram matrix G = D^T D (n, n)."""

    @abc.abstractmethod
    def init(self, x0: Optional[Tensor]) -> Tensor:
        """Establish iterate state; return d = D^T(y0 - lam0). ``x0``
        None is the cold start (y = lam = 0 without touching D)."""

    @abc.abstractmethod
    def sweep(self, x: Tensor, k: int) -> Optional[SweepResult]:
        """One fused pass over all rows for iteration ``k`` (1-based):
        update the backend's (y, lam), return the reductions. ``None``
        stops the solve with ``status='degraded'``."""

    # -- shared-driver hooks (defaults fit most backends) -------------------
    def zero_x(self) -> Tensor:
        shape = (self.n,) if self.ycols == 1 else (self.n, self.ycols)
        return torch.zeros(shape, dtype=self.acc, device=self.device)

    def pad_objective(self) -> float:
        return 0.0

    def extra_record(self) -> dict:
        """Backend-specific keys merged into each telemetry record."""
        return {}

    def finish(self, iters: int, converged: bool):
        """Post-loop bookkeeping (cluster status accounting)."""

    # -- checkpoint ownership: backend owns SHAPES, driver owns CADENCE -----
    def state_like(self) -> dict:
        yshape = (self.m,) if self.ycols == 1 else (self.m, self.ycols)
        z = torch.zeros(yshape, dtype=self.acc, device=self.device)
        return {"x": self.zero_x(), "y": z, "lam": z, "d": self.zero_x()}

    def checkpoint_extra(self) -> dict:
        return {}

    def verify_checkpoint(self, extra: dict):
        """Raise ``error_cls`` when the checkpoint belongs elsewhere."""

    def restore_placements(self) -> Optional[dict]:
        """Where each restored leaf goes (``CheckpointManager.restore``'s
        ``placements``), or None for the devices of ``state_like``."""
        return None

    def restore_state(self, k: int, tree: dict) -> Tensor:
        """Adopt restored (y, lam); return the restored d."""
        raise self.error_cls(
            f"{self.name} executor does not support resume")

    def state_arrays(self, k: int) -> Optional[dict]:
        """{"y": ..., "lam": ...} at iteration k, or None to skip this
        checkpoint round."""
        return None

    def on_checkpointed(self, k: int, state: dict):
        """A checkpoint at k was committed."""

    @abc.abstractmethod
    def final_iterates(self) -> Tuple[Tensor, Tensor]:
        """(y, lam) in the node-stacked ADMMResult convention."""


# ---------------------------------------------------------------------------
# THE driver
# ---------------------------------------------------------------------------

def solve_with_executor(ex: SolveExecutor, *, loss, tau: float,
                        rho: float = 0.0, eps_rel: float = 1e-3,
                        eps_abs: float = 1e-6, max_iters: int = 500,
                        x0: Optional[Tensor] = None, record: bool = False,
                        reg: Optional[Regularizer] = None,
                        checkpoint_dir: Optional[str] = None,
                        checkpoint_every: int = 0, resume: bool = False,
                        obs=None):
    """Unwrapped ADMM (paper Alg. 1/2) over any :class:`SolveExecutor`:
    the x-update (Cholesky on the cached Gram, or the composite
    prox-gradient when ``reg`` is given), Boyd's stopping rule, warm
    starts, checkpoint cadence + resume validation, the pad-objective
    correction and history. Returns an
    :class:`~repro_torch.core.unwrapped.ADMMResult`.

    The per-iteration scalars reach the host in ONE transfer: the norms
    are taken on the device and stacked, then ``.tolist()`` syncs once."""
    from repro_torch.core.unwrapped import ADMMHistory, ADMMResult

    if obs is not None:
        raise NotImplementedError(
            "observability (repro.obs) is not ported yet (ROADMAP item 10)")
    m, n, K = ex.m, ex.n, ex.ycols
    m_eff, n_eff = m * K, n * K

    G = ex.setup()
    if reg is None:
        L = gram_lib.gram_factor(G, ridge=rho / tau)
        lmax = None
    else:
        L = None
        lmax = power_lmax(G)

    manager = None
    if checkpoint_dir is not None:
        from repro_torch.checkpoint.manager import CheckpointManager
        manager = CheckpointManager(checkpoint_dir)

    k = 0
    ex.resume_iter = 0
    if manager is not None and resume and manager.latest_step() is not None:
        tree, extra = manager.restore(ex.state_like(),
                                      fallback=ex.restore_fallback,
                                      placements=ex.restore_placements())
        if extra.get("kind") != ex.checkpoint_kind:
            raise ex.error_cls(
                f"not a {ex.kind_label} checkpoint: {extra}")
        ex.verify_checkpoint(extra)
        k = int(extra["iter"])
        ex.resume_iter = k
        d = ex.restore_state(k, tree)
        x = tree["x"]            # returned as-is if no iterations remain
    else:
        d = ex.init(x0)
        x = ex.zero_x()

    pad_obj = ex.pad_objective()
    objs, rs, ss = [], [], []
    k_conv = -1
    while k < max_iters:
        if reg is None:
            x = gram_lib.gram_solve(L, d)
        else:
            x = composite_x_update(G, lmax, d, x, tau, reg.prox,
                                   reg.inner_iters)
        sw = ex.sweep(x, k + 1)
        if sw is None:           # degraded stop: best-so-far x
            break
        d = sw.d
        parts = [torch.sqrt(sw.r_sq), torch.linalg.norm(sw.w),
                 torch.sqrt(sw.dx_sq), torch.sqrt(sw.y_sq),
                 torch.linalg.norm(sw.v), sw.obj]
        if rho:
            parts.append(torch.sum(x ** 2))
        if reg is not None:
            parts.append(reg.value(x))
        vals = torch.stack([p.to(torch.float64) for p in parts]).tolist()
        r = vals[0]
        s = tau * vals[1]
        eps_pri = math.sqrt(m_eff) * eps_abs + eps_rel * max(vals[2],
                                                             vals[3])
        eps_dual = math.sqrt(n_eff) * eps_abs + eps_rel * tau * vals[4]
        k += 1
        if record:
            obj = vals[5] - pad_obj
            if rho:
                obj += 0.5 * rho * vals[6]
            if reg is not None:
                obj += vals[-1]
            objs.append(obj)
            rs.append(r)
            ss.append(s)
        if manager is not None and checkpoint_every \
                and k % checkpoint_every == 0:
            state = ex.state_arrays(k)
            if state is not None:
                if ex.writes_checkpoint:
                    manager.save(k, {"x": x, "y": state["y"],
                                     "lam": state["lam"], "d": d},
                                 extra={"kind": ex.checkpoint_kind,
                                        "iter": k,
                                        **ex.checkpoint_extra()})
                ex.on_checkpointed(k, state)
        if r <= eps_pri and s <= eps_dual:
            k_conv = k - 1
            break

    ex.finish(k, k_conv >= 0)
    history = None
    if record:
        acc = ex.acc
        history = ADMMHistory(torch.tensor(objs, dtype=acc),
                              torch.tensor(rs, dtype=acc),
                              torch.tensor(ss, dtype=acc),
                              torch.full((len(objs),), math.nan, dtype=acc),
                              k_conv)
    y, lam = ex.final_iterates()
    return ADMMResult(x, y, lam, k, history)
