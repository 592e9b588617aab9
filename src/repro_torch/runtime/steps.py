"""Train / serve step builders; port of ``repro/runtime/steps.py``.

train_step: loss -> grads -> optimizer update, with optional gradient
accumulation over microbatches (a Python loop: peak activation memory is
one microbatch). Gradients come from plain autograd on the parameter
leaves, and the update writes the parameter and state tensors in place
(``optim/optimizers.py``). serve_step: one decode token against the
KV/state caches.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import decode_step
from repro_torch.models.model import loss_fn, tree_map, zip_leaves
from repro_torch.optim.optimizers import make_optimizer


def _leaves(tree):
    return [t for (t,) in zip_leaves(tree)]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _leaves(tree)))


def split_microbatches(batch, microbatches: int):
    """``microbatches`` batches along the batch axis; M-RoPE positions
    (3, B, S) split along axis 1."""
    def split(k, v):
        axis = 1 if k == "positions" and v.dim() == 3 else 0
        if v.shape[axis] % microbatches:
            raise ValueError(f"batch of {v.shape[axis]} does not split "
                             f"into {microbatches} microbatches")
        return v.chunk(microbatches, dim=axis)
    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(microbatches)]


def make_train_step(cfg: ModelConfig, optimizer=None, *, microbatches: int = 1,
                    clip_norm: float = 1.0):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``, metrics 0-d tensors ``loss``, ``grad_norm``, ``ce`` and
    ``aux``. Attention and WKV always take the reference's chunked paths."""
    if optimizer is None:
        optimizer = make_optimizer(cfg.optimizer)
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches} must be >= 1")

    def loss_and_backward(params, batch):
        # K4 and K5 have no backward: their "cuda" impls raise under grad
        loss, metrics = loss_fn(params, cfg, batch, attn_impl="xla",
                                wkv_impl="xla")
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(params, opt_state, batch, step):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                if microbatches == 1:
                    loss, metrics = loss_and_backward(params, batch)
                else:
                    l_acc = a_acc = 0.0
                    for mb in split_microbatches(batch, microbatches):
                        loss, m = loss_and_backward(params, mb)
                        l_acc = l_acc + loss
                        a_acc = a_acc + m["aux"]
                    loss = l_acc / microbatches
                    metrics = {"ce": loss, "aux": a_acc / microbatches}
            # a leaf the loss does not reach (the embedding, when a VLM
            # batch carries embeds) has no grad: zero, as in the reference
            grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                             else p.grad, params)
        finally:
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
        with torch.no_grad():
            if microbatches > 1:
                for g in _leaves(grads):
                    g.div_(microbatches)
            gnorm = global_norm(grads)
            scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            for g in _leaves(grads):
                g.mul_(scale)
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 step)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   **metrics}

    return train_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, caches, tokens, pos):
        return decode_step(params, cfg, caches, tokens=tokens, pos=pos)
    return serve_step
