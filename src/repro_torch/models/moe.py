"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch;
port of ``repro/models/moe.py``.

Dispatch is SORT-BASED (gather/scatter), not one-hot-einsum: tokens are
ordered by destination expert with a stable argsort, assigned a rank within
their expert queue, and dropped beyond capacity C = T*k/E * capacity_factor.
Expert compute is then a dense (E, C, d) batched matmul over gathered rows
(``torch.bmm``: plain large products, which the reference leaves to XLA's
einsum outside any Pallas kernel).

The combine differs in form from the reference's, not in value. The
reference scatter-adds every slot's output into its token
(``.at[grid_tok].add``), which on the card would be ``index_add_`` with
float atomics, whose sums change from run to run. Here each token gathers
its own kept slots and adds them in ascending slot order, the order in
which the reference's scatter visits them, in the compute dtype from zeros:
the result repeats bit for bit and matches the reference's order.

Ties in the top-k: ``lax.top_k`` puts the lower expert index first. The
port takes the top k of a stable descending sort, which does the same
(``torch.topk`` promises no order for exact ties).

The router's product is f32 and relies on PyTorch's default float32 matmul
precision ("highest"): TF32 must stay off on the card.

Covers olmoe-1b-7b (64e top-8) and arctic-480b (128e top-2 + dense residual).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, init_mlp, mlp

Tensor = torch.Tensor

# When a list, ``moe_ffn`` appends (kept (token, expert) pairs as a 0-d
# tensor, routed pairs) for each call: the share that capacity drops. No
# host sync is added; the reader sums the tensors.
DROP_STATS: Optional[list] = None


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    d, ffm, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, (d, E), torch.float32),  # router kept f32
        "we1": dense_init(gen, (E, d, ffm), cfg.param_dtype),
        "we3": dense_init(gen, (E, d, ffm), cfg.param_dtype),
        "we2": dense_init(gen, (E, ffm, d), cfg.param_dtype),
    }
    if cfg.moe_dense_residual:
        p["dense"] = init_mlp(gen, d, cfg.d_ff, cfg.param_dtype)
    return p


def route_topk(logits: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(T, E) router logits -> (weights (T,k), experts (T,k), aux loss)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = srt.values[:, :k], srt.indices[:, :k]
    topw = topw / topw.sum(dim=-1, keepdim=True)
    # Switch-style load-balance loss: E * <f_e, p_e>.
    me = probs.mean(dim=0)
    fe = torch.bincount(topi.reshape(-1), minlength=E).float()
    fe = fe / torch.clamp(fe.sum(), min=1.0)
    aux = E * torch.sum(me * fe)
    return topw, topi, aux


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: max(1, round(T k / E * factor))."""
    return int(max(1, round(T * cfg.experts_per_token / cfg.num_experts
                            * cfg.capacity_factor)))


def moe_ffn(params, cfg: ModelConfig, x: Tensor, *,
            capacity_override: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (out, aux_loss). Sort-based capacity dispatch."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, d)
    cdt = cfg.compute_dtype
    dev = x.device

    logits = xt.float() @ params["router"].float()             # (T, E)
    topw, topi, aux = route_topk(logits, k)

    C = capacity_override or capacity(cfg, T)

    # ---- sort by expert, rank within expert, drop beyond capacity ----
    e_flat = topi.reshape(-1)                                   # (T*k,)
    w_flat = topw.reshape(-1)
    t_flat = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.sort(e_flat, stable=True).indices             # token-priority
    e_s, w_s, t_s = e_flat[order], w_flat[order], t_flat[order]
    counts = torch.bincount(e_s, minlength=E)
    starts = torch.cumsum(counts, 0) - counts                   # exclusive
    rank = torch.arange(T * k, device=dev) - starts[e_s]
    keep = rank < C
    # Over-capacity entries go to the out-of-range slot E*C (dropped).
    slot = torch.where(keep, e_s * C + rank, E * C)             # (T*k,)
    if DROP_STATS is not None:
        DROP_STATS.append((keep.sum(), T * k))

    # (E*C,) gather grid; sentinel row T => zero input. Kept slots are
    # distinct, so the writes below never collide.
    grid_tok = torch.full((E * C,), T, dtype=torch.long, device=dev)
    grid_tok[slot[keep]] = t_s[keep]
    grid_w = torch.zeros((E * C,), dtype=torch.float32, device=dev)
    grid_w[slot[keep]] = w_s[keep]

    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    expert_in = xt_pad[grid_tok].reshape(E, C, d)               # gather
    h = torch.nn.functional.silu(
        torch.bmm(expert_in, params["we1"].to(cdt))
    ) * torch.bmm(expert_in, params["we3"].to(cdt))
    expert_out = torch.bmm(h, params["we2"].to(cdt))
    expert_out = expert_out.reshape(E * C, d) * grid_w[:, None].to(cdt)

    # ---- combine: each token gathers its k slots in ascending order ----
    tok_slot = torch.empty_like(slot)
    tok_slot[order] = slot
    tok_slot = torch.sort(tok_slot.reshape(T, k), dim=1).values
    out_pad = torch.cat([expert_out, expert_out.new_zeros((1, d))], dim=0)
    out = torch.zeros((T, d), dtype=cdt, device=dev)
    for j in range(k):    # a dropped pair reads the zero row E*C, last
        out = out + out_pad[tok_slot[:, j]]

    if cfg.moe_dense_residual:
        out = out + mlp(params["dense"], xt, cdt)
    return out.reshape(B, S, d), aux.float()


def moe_ffn_dense_ref(params, cfg: ModelConfig, x: Tensor) -> Tensor:
    """No-capacity dense reference (every token gets its exact top-k mix);
    used by tests to validate the dispatch path with a large capacity."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(-1, d)
    cdt = cfg.compute_dtype
    logits = xt.float() @ params["router"].float()
    topw, topi, _ = route_topk(logits, k)
    h = torch.nn.functional.silu(
        torch.einsum("td,edf->tef", xt, params["we1"].to(cdt))
    ) * torch.einsum("td,edf->tef", xt, params["we3"].to(cdt))
    every = torch.einsum("tef,efd->ted", h, params["we2"].to(cdt))  # (T,E,d)
    w_full = torch.zeros((xt.shape[0], E), dtype=torch.float32,
                         device=x.device).scatter(1, topi, topw)
    out = torch.einsum("te,ted->td", w_full.to(cdt), every)
    if cfg.moe_dense_residual:
        out = out + mlp(params["dense"], xt, cdt)
    return out.reshape(B, S, d)
