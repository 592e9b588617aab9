"""Optimizers: AdamW and Adafactor on the port's parameter trees; port of
``repro/optim/optimizers.py``.

Trees are nests of dicts and lists of tensors, as ``models/model.py``'s
``tree_map`` walks them; the state trees have the reference's layout:
``{"m": tree, "v": tree}`` for AdamW, ``{"f": tree of {"vr", "vc"} or
{"v"}}`` for Adafactor (a leaf of two or more axes factors its last two).
Trees are matched by key, not by the order of their dicts, so a state tree
carried from the JAX package (sorted keys) pairs with the port's params.

The update runs in f32 under ``torch.no_grad()`` and writes the parameter
and state tensors **in place**: the counterpart of the reference's
``donate_argnums=(0, 1)`` (``repro/launch/train.py``), without which a
full-size step would hold two copies of the parameters. ``update`` still
returns ``(params, state)``, the same objects. The schedule and the bias
corrections are f32 0-d tensors, as ``jnp`` computes them for an array
step, each elementwise step in the reference's order.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.model import tree_map, zip_leaves


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def _cosine_lr(lr, step, warmup, total):
    """``step`` as an f32 0-d tensor; (step+1)/warmup: never a dead zero-lr
    first step."""
    warm = torch.clamp((step + 1.0) / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return lr * warm * (0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * prog)))


def _device(params):
    return next(zip_leaves(params))[0].device


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000

    def init(self, params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def schedule(self, step):
        return _cosine_lr(self.lr, _f32(step, "cpu"), self.warmup_steps,
                          self.total_steps)

    @torch.no_grad()
    def update(self, grads, state, params, step):
        s = _f32(step, _device(params))
        lr = _cosine_lr(self.lr, s, self.warmup_steps, self.total_steps)
        t = s + 1
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        for g, m, v, p in zip_leaves(grads, state["m"], state["v"], params):
            gf = g.float()
            m.mul_(self.b1).add_((1 - self.b1) * gf)
            v.mul_(self.b2).add_((1 - self.b2) * gf * gf)
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            pf = p.float()
            pf.mul_(1 - lr * self.weight_decay).sub_(lr * upd)
            if pf is not p:
                p.copy_(pf)
        return params, state


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second moment (Shazeer & Stern 2018), no first moment: the
    memory plan for arctic-480b, O(rows + cols) state per matrix instead of
    O(rows x cols)."""

    lr: float = 1e-3
    decay: float = 0.8          # beta2_t = 1 - t^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000

    def init(self, params):
        def per_leaf(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if p.dim() >= 2:
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"f": tree_map(per_leaf, params)}

    def schedule(self, step):
        return self._lr(_f32(step, "cpu"))

    def _lr(self, step):
        return self.lr * torch.clamp(
            (step + 1.0) / max(self.warmup_steps, 1), max=1.0)

    @torch.no_grad()
    def update(self, grads, state, params, step):
        s = _f32(step, _device(params))
        lr = self._lr(s)
        beta2 = 1.0 - (s + 1) ** (-self.decay)
        for g, f, p in zip_leaves(grads, state["f"], params):
            gf = g.float()
            g2 = gf * gf + self.eps
            if p.dim() >= 2:
                vr, vc = f["vr"], f["vc"]
                vr.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
                vc.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
                denom = torch.clamp(vr.mean(dim=-1, keepdim=True),
                                    min=self.eps)
                v_est = g2     # its buffer, g2 no longer needed
                torch.mul(vr[..., :, None], vc[..., None, :], out=v_est)
                v_est.div_(denom[..., None])
            else:
                f["v"].mul_(beta2).add_((1 - beta2) * g2)
                v_est = f["v"]
            u = gf / (v_est + self.eps).sqrt_()
            rms = torch.sqrt(torch.mean(u * u) + self.eps)
            u.div_(torch.clamp(rms / self.clip_threshold, min=1.0))
            pf = p.float()
            pf.sub_(lr * u)
            if pf is not p:
                p.copy_(pf)
        return params, state


def make_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise ValueError(name)
