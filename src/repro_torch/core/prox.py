"""Proximal operators and loss objects — the paper's y-update building
blocks; port of the part of ``repro/core/prox.py`` the dense solve needs.

Every separable term ``f`` used by unwrapped ADMM (paper Alg. 1/2) is a
:class:`ProxLoss`: the loss value ``f(z)``, its proximal map
``prox_f(z, delta) = argmin_y f(y) + ||y - z||^2 / (2 delta)`` and, when f
is differentiable, its gradient. All maps are coordinatewise and act on
tensors on any device; the CUDA kernels evaluate the same maps in
registers (``kernels/csrc/prox.cuh``).

The five kinds the kernels evaluate are logistic, hinge, l1,
least_squares and quantile. Huber, multinomial and ``StackedProx`` have no
kernel kind: the engine runs them through its torch bodies, as the
reference runs them outside Pallas. Group sums (``group_soft_threshold``)
are a product with a one-hot (n x G) matrix, a fixed order of summation:
``index_add_`` / ``scatter_add_`` would add with float atomics on the card
and lose bitwise-repeatable solves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ProxLoss:
    """A separable convex term f with a proximal map.

    Attributes:
      name: identifier used by kernels/config.
      value: ``f(z, aux) -> scalar`` (sum over coordinates).
      prox: ``prox(z, delta, aux) -> y`` with delta the prox weight (tau^-1).
      grad: coordinatewise gradient (None for non-smooth terms).
      lipschitz: Lipschitz constant of grad (paper: logistic = 1/4).
      coordinatewise: True when prox acts per coordinate with per-row aux —
        what the engine needs to stream arbitrary row blocks.
      kernel_delta_scale: the prox kernel evaluates the BARE map for
        ``name`` at a given delta; losses that fold a weight into their
        prox (hinge absorbs C) record it here, and the engine passes
        delta * scale to the kernel.
      kernel_param: extra parameter the kernel prox needs beyond delta
        (quantile level q); 0.0 for parameter-free kinds.
      ycols: columns of the splitting variable y (and of x). 1 for
        scalar-response losses; K for multinomial logistic, whose iterates
        are (m, K) matrices through the same multi-RHS Gram machinery.
      spec: picklable ``{"name": ..., **params}`` rebuilding this loss via
        :func:`loss_from_spec`.
    """

    name: str
    value: Callable[[Tensor, Optional[Tensor]], Tensor]
    prox: Callable[[Tensor, float, Optional[Tensor]], Tensor]
    grad: Optional[Callable[[Tensor, Optional[Tensor]], Tensor]] = None
    lipschitz: Optional[float] = None
    coordinatewise: bool = True
    kernel_delta_scale: float = 1.0
    kernel_param: float = 0.0
    ycols: int = 1
    spec: Optional[dict] = dataclasses.field(default=None, compare=False)


# ---------------------------------------------------------------------------
# Elementary maps
# ---------------------------------------------------------------------------

def soft_threshold(z: Tensor, thresh) -> Tensor:
    """prox of ``thresh * |.|`` — the lasso shrink."""
    return torch.sign(z) * torch.clamp(torch.abs(z) - thresh, min=0.0)


def project_linf(z: Tensor, radius) -> Tensor:
    """Projection onto the l-inf ball (dual lasso constraint, paper
    section 7.1)."""
    return torch.clamp(z, -radius, radius)


def softplus(x: Tensor) -> Tensor:
    """log(1 + exp(x)), as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def logistic_prox_newton(z: Tensor, delta, labels: Tensor,
                         bisect_iters: int = 40,
                         newton_iters: int = 3) -> Tensor:
    """prox of the logistic NLL ``log(1 + exp(-l*y))``.

    phi'(y) = -l*sigmoid(-l y) + (y-z)/d is strictly increasing with a
    sign change on [z-d, z+d], so the bracket is bisected (undamped Newton
    oscillates for large d) and polished with a few Newton steps clamped
    to the bracket size.
    """
    delta = float(delta)

    def dphi(y):
        return -labels * torch.sigmoid(-labels * y) + (y - z) / delta

    lo = z - delta
    hi = z + delta
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        pos = dphi(mid) > 0
        lo, hi = torch.where(pos, lo, mid), torch.where(pos, mid, hi)
    y = 0.5 * (lo + hi)
    for _ in range(newton_iters):
        s = torch.sigmoid(-labels * y)
        g = -labels * s + (y - z) / delta
        h = s * (1.0 - s) + 1.0 / delta
        y = y - torch.clamp(g / h, -delta, delta)
    return y


def hinge_prox(z: Tensor, delta, labels: Tensor) -> Tensor:
    """prox of the hinge loss sum_k max(1 - l_k z_k, 0) (paper section 6.2):
    prox_h(z, d)_k = z_k + l_k * max(min(1 - l_k z_k, d), 0)."""
    return z + labels * torch.clamp(
        torch.clamp(1.0 - labels * z, max=float(delta)), min=0.0)


# ---------------------------------------------------------------------------
# ProxLoss instances
# ---------------------------------------------------------------------------

def make_logistic(labels_required: bool = True) -> ProxLoss:
    """Paper section 6.1 — f_lr(z) = sum log(1 + exp(-l z))."""

    def value(z, aux):
        return torch.sum(softplus(-aux * z))

    def prox(z, delta, aux):
        return logistic_prox_newton(z, delta, aux)

    def grad(z, aux):
        return -aux * torch.sigmoid(-aux * z)

    return ProxLoss("logistic", value, prox, grad, lipschitz=0.25)


def make_hinge(C: float = 1.0) -> ProxLoss:
    """Paper section 6.2 — SVM hinge term C * h(z). The prox weight
    absorbs C: prox_{C h}(z, d) = prox_h(z, C d)."""

    def value(z, aux):
        return C * torch.sum(torch.clamp(1.0 - aux * z, min=0.0))

    def prox(z, delta, aux):
        return hinge_prox(z, C * delta, aux)

    return ProxLoss("hinge", value, prox, grad=None, lipschitz=None,
                    kernel_delta_scale=C)


def make_l1(mu: float) -> ProxLoss:
    """mu * |z| — the sparsity block of paper section 7."""

    def value(z, aux):
        return mu * torch.sum(torch.abs(z))

    def prox(z, delta, aux):
        return soft_threshold(z, mu * delta)

    return ProxLoss("l1", value, prox, grad=None, lipschitz=None,
                    kernel_delta_scale=mu)


def make_least_squares() -> ProxLoss:
    """0.5 * ||z - b||^2 with b passed as aux (lasso residual block)."""

    def value(z, aux):
        return 0.5 * torch.sum((z - aux) ** 2)

    def prox(z, delta, aux):
        delta = float(delta)
        return (z + delta * aux) / (1.0 + delta)

    def grad(z, aux):
        return z - aux

    return ProxLoss("least_squares", value, prox, grad, lipschitz=1.0)


def make_quantile(q: float = 0.5) -> ProxLoss:
    """Pinball (quantile) loss sum_k rho_q(z_k - b_k), b passed as aux.
    The prox is a two-sided asymmetric soft-threshold on r0 = z - b."""
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile level must be in (0, 1), got {q}")

    def value(z, aux):
        r = z - aux
        return torch.sum(torch.where(r >= 0, q * r, (q - 1.0) * r))

    def prox(z, d, aux):
        d = float(d)
        r0 = z - aux
        r = torch.where(r0 > d * q, r0 - d * q,
                        torch.where(r0 < -d * (1.0 - q), r0 + d * (1.0 - q),
                                    torch.zeros_like(r0)))
        return aux + r

    return ProxLoss("quantile", value, prox, grad=None, lipschitz=None,
                    kernel_delta_scale=1.0, kernel_param=float(q),
                    spec={"name": "quantile", "q": float(q)})


def make_huber(delta: float = 1.0) -> ProxLoss:
    """Huber loss sum_k h_delta(z_k - b_k) with b passed as aux: r^2/2 for
    |r| <= delta, delta (|r| - delta/2) beyond. The prox shrinks the
    residual r0 = z - b by 1/(1+d) in the quadratic region and shifts it by
    d delta toward zero in the linear one; the branches meet at
    |r0| = delta (1 + d)."""

    def value(z, aux):
        r = z - aux
        a = torch.abs(r)
        return torch.sum(torch.where(a <= delta, 0.5 * r * r,
                                     delta * (a - 0.5 * delta)))

    def prox(z, d, aux):
        d = float(d)
        r0 = z - aux
        r = torch.where(torch.abs(r0) <= delta * (1.0 + d), r0 / (1.0 + d),
                        r0 - d * delta * torch.sign(r0))
        return aux + r

    def grad(z, aux):
        return torch.clamp(z - aux, -delta, delta)

    return ProxLoss("huber", value, prox, grad, lipschitz=1.0)


def multinomial_prox_newton(z: Tensor, delta, labels: Tensor,
                            newton_iters: int = 12) -> Tensor:
    """Row-wise prox of the multinomial (softmax cross-entropy) NLL:
    argmin_y logsumexp(y) - y_c + ||y - z||^2 / (2 delta) per row.

    The Hessian is diag(p) - p p^T + I/delta with p = softmax(y), so each
    Newton solve is Sherman-Morrison against A = diag(p + 1/delta); the
    CE gradient is bounded by 1 per coordinate, so steps are clipped to
    |y - z| <= delta."""
    delta = float(delta)
    onehot = F.one_hot(labels.long(), z.shape[-1]).to(z.dtype)
    y = z
    for _ in range(newton_iters):
        p = torch.softmax(y, dim=-1)
        g = p - onehot + (y - z) / delta
        a = p + 1.0 / delta
        u = g / a
        t = torch.sum(p * u, dim=-1, keepdim=True) / (
            1.0 - torch.sum(p * p / a, dim=-1, keepdim=True))
        step = u + (p / a) * t
        y = y - torch.clamp(step, -delta, delta)
    return y


def make_multinomial(classes: int) -> ProxLoss:
    """Multinomial logistic (softmax cross-entropy) over K classes: y and x
    are (rows, K) matrices, aux holds integer class labels in [0, K)."""
    if classes < 2:
        raise ValueError(f"multinomial needs >= 2 classes, got {classes}")

    def value(z, aux):
        lab = aux.long()
        lse = torch.logsumexp(z, dim=-1)
        picked = torch.gather(z, -1, lab[..., None])[..., 0]
        return torch.sum(lse - picked)

    def prox(z, delta, aux):
        return multinomial_prox_newton(z, delta, aux)

    def grad(z, aux):
        onehot = F.one_hot(aux.long(), z.shape[-1]).to(z.dtype)
        return torch.softmax(z, dim=-1) - onehot

    return ProxLoss("multinomial", value, prox, grad, lipschitz=0.5,
                    coordinatewise=False, ycols=int(classes),
                    spec={"name": "multinomial", "classes": int(classes)})


def group_onehot(groups, num_groups: int, dtype, device) -> Tensor:
    """The (n, G) one-hot of a coordinate -> group map: ``v @ onehot``
    sums v over each group in a fixed order."""
    g = torch.as_tensor(groups, device=device).long()
    return F.one_hot(g, num_groups).to(dtype)


def group_soft_threshold(z: Tensor, thresh, groups,
                         num_groups: int) -> Tensor:
    """prox of ``thresh * sum_g ||z_g||_2`` — the group-lasso shrink: each
    group's subvector is scaled by max(0, 1 - thresh/||z_g||), so whole
    groups hit zero together (Yuan & Lin 2006)."""
    onehot = group_onehot(groups, num_groups, z.dtype, z.device)
    nrm = torch.sqrt((z * z) @ onehot)
    scale = torch.where(nrm > thresh,
                        1.0 - thresh / torch.clamp(nrm, min=1e-30),
                        torch.zeros_like(nrm))
    return z * (onehot @ scale)


def project_nonneg(z: Tensor) -> Tensor:
    """Projection onto the nonnegative orthant (NNLS constraint)."""
    return torch.clamp(z, min=0.0)


def make_linf_ball(radius: float) -> ProxLoss:
    """Characteristic function of the l-inf ball (dual lasso, paper
    section 7.1)."""

    def value(z, aux):
        return torch.zeros((), dtype=z.dtype, device=z.device)

    def prox(z, delta, aux):
        return project_linf(z, radius)

    return ProxLoss("linf_ball", value, prox, grad=None, lipschitz=None)


def make_shifted_least_squares() -> ProxLoss:
    """0.5 * ||z + b||^2 — the dual-lasso data block f*(alpha) (paper
    section 7.1)."""

    def value(z, aux):
        return 0.5 * torch.sum((z + aux) ** 2)

    def prox(z, delta, aux):
        delta = float(delta)
        return (z - delta * aux) / (1.0 + delta)

    def grad(z, aux):
        return z + aux

    return ProxLoss("shifted_least_squares", value, prox, grad,
                    lipschitz=1.0)


@dataclasses.dataclass(frozen=True)
class StackedProx:
    """Blockwise f-hat for the sparse formulation (paper section 7):
    mu |z_k| for k < n (identity block), f(z_k) for k >= n. ``sizes`` are
    the block lengths in stacking order; each block has its own ProxLoss
    and aux slice."""

    blocks: Tuple[ProxLoss, ...]
    sizes: Tuple[int, ...]

    def _split(self, z: Tensor):
        out, off = [], 0
        for s in self.sizes:
            out.append(z.narrow(z.dim() - 1, off, s))
            off += s
        return out

    def value(self, z: Tensor, aux) -> Tensor:
        parts = self._split(z)
        auxs = self._split(aux) if aux is not None else [None] * len(parts)
        return sum(b.value(p, a) for b, p, a in zip(self.blocks, parts, auxs))

    def prox(self, z: Tensor, delta, aux) -> Tensor:
        parts = self._split(z)
        auxs = self._split(aux) if aux is not None else [None] * len(parts)
        return torch.cat([b.prox(p, delta, a) for b, p, a
                          in zip(self.blocks, parts, auxs)], dim=z.dim() - 1)

    def as_loss(self, name: str = "stacked") -> ProxLoss:
        # position-dependent prox: the engine may not stream arbitrary row
        # chunks, so it runs the reference body
        return ProxLoss(name, self.value, self.prox, grad=None,
                        lipschitz=None, coordinatewise=False)


def loss_from_spec(spec: dict) -> ProxLoss:
    """ProxLoss from a picklable ``{"name": ..., **params}`` spec — the
    same specs the JAX package writes (``repro.core.prox.loss_from_spec``)."""
    name = spec["name"]
    if name == "logistic":
        loss = make_logistic()
    elif name == "hinge":
        loss = make_hinge(float(spec.get("C", 1.0)))
    elif name == "least_squares":
        loss = make_least_squares()
    elif name == "l1":
        loss = make_l1(float(spec.get("mu", 1.0)))
    elif name == "quantile":
        loss = make_quantile(float(spec.get("q", 0.5)))
    elif name == "huber":
        loss = make_huber(float(spec.get("delta", 1.0)))
    elif name == "multinomial":
        loss = make_multinomial(int(spec["classes"]))
    else:
        raise ValueError(f"unknown loss spec {name!r}")
    return dataclasses.replace(loss, spec=dict(spec))


LOSSES = {
    "logistic": make_logistic,
    "hinge": make_hinge,
    "huber": make_huber,
    "l1": make_l1,
    "least_squares": make_least_squares,
    "linf_ball": make_linf_ball,
    "shifted_least_squares": make_shifted_least_squares,
    "quantile": make_quantile,
    "multinomial": make_multinomial,
}
