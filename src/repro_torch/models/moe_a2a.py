"""Explicit all-to-all Expert Parallelism for the MoE FFN; port of
``repro/models/moe_a2a.py``.

A DeepSeek-/GShard-style two-hop dispatch over the 'model' line of a grid
of ranks (``sharding.compat.Grid``), where tokens travel point-to-point:

  1. each rank of a 'model' line holds the same (B_loc, S, d) activations
     (attention and the dense layers run replicated along 'model') and
     routes its own S/M of them, in the reference's token order;
  2. token copies are packed into per-destination-rank capacity buffers
     (Csend slots each) and exchanged with ONE ``all_to_all_single`` over
     the line;
  3. each rank runs its local experts (E_loc of them) as dense
     (E_loc, C_loc, d) products (``torch.bmm``, as the reference's einsums
     sit outside any Pallas kernel);
  4. a reverse all_to_all returns outputs in the SAME buffer layout, so the
     source rank combines them with its saved slot mapping and top-k
     weights; an all-gather over the line restores (B_loc, S, d), which is
     what GSPMD does after the reference's ``out_specs``.

Wire per layer per rank ~= 2 x Csend x M x d x dtype (the two token hops)
plus the expert ids of hop 1. Drops follow the reference's two-stage
capacity (per destination rank, then per local expert), with the same
stable orders, so the same (token, expert) pairs are dropped.

The reference scatter-adds twice (the return buffer, the combine); here
both are gathers, with no float atomics: each buffer row gathers its own
expert row (or the zero row when it was dropped), and each token gathers
its k slots and adds them in ascending slot order from zeros, as
``models/moe.py`` does.

Fallbacks: with no joined grid, no 'model' axis, a 'model' axis of one
rank, or S not divisible by M, this is ``moe_ffn``. The reference falls
back in the first, second and fourth cases; on a 'model' axis of one it
runs this body with M = 1, whose capacities differ from ``moe_ffn``'s. The
port keeps ``moe_ffn`` there so that one rank gives ``moe_ffn``'s result
bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp
from repro_torch.sharding import compat, specs

Tensor = torch.Tensor

EXPERT_KEYS = ("we1", "we3", "we2")


def capacities(cfg: ModelConfig, T: int, M: int,
               send_cf: Optional[float] = None,
               recv_cf: Optional[float] = None) -> Tuple[int, int]:
    """(Csend, C_loc): slots per destination rank for T routed tokens, and
    slots per local expert for the M * Csend received rows."""
    if send_cf is None:
        send_cf = cfg.capacity_factor
    if recv_cf is None:
        recv_cf = max(1.25 * cfg.capacity_factor, 1.5)
    k, E_loc = cfg.experts_per_token, cfg.num_experts // M
    Csend = int(max(1, round(T * k / M * send_cf)))
    R = M * Csend
    C_loc = int(max(1, round(R / max(E_loc, 1) * recv_cf)))
    return Csend, C_loc


def hop_bytes(cfg: ModelConfig, T: int, M: int, itemsize: int) -> int:
    """The formula: bytes one rank sends through the two token hops of a
    layer, 2 x Csend x M x d x itemsize (the expert-id hop, Csend x M
    int64, not included)."""
    Csend, _ = capacities(cfg, T, M)
    return 2 * Csend * M * cfg.d_model * itemsize


def _scatter_ids(n: int, idx: Tensor, val: Tensor, fill: int) -> Tensor:
    """An (n,) id grid: ``val`` at ``idx``; entries with idx == n (dropped)
    land in a sentinel row that is cut off. Kept indices are distinct, so
    no write collides with another that is kept."""
    out = torch.full((n + 1,), fill, dtype=torch.long, device=idx.device)
    out[idx] = val.long()
    return out[:n]


def moe_ffn_a2a_local(params, cfg: ModelConfig, x_loc: Tensor, *,
                      group, M: int,
                      send_cf: Optional[float] = None,
                      recv_cf: Optional[float] = None,
                      count_drops: bool = True) -> Tuple[Tensor, Tensor]:
    """Local body on one rank of a 'model' line of M ranks (``group``).
    x_loc: (T_dev, d). Experts of ``params`` are the LOCAL shard
    (E_loc, d, ffm). Returns (out (T_dev, d), aux averaged over the
    line)."""
    T, d = x_loc.shape
    E = cfg.num_experts
    k = cfg.experts_per_token
    E_loc = E // M
    cdt = cfg.compute_dtype
    dev = x_loc.device
    Csend, C_loc = capacities(cfg, T, M, send_cf, recv_cf)

    logits = x_loc.float() @ params["router"].float()
    topw, topi, aux = moe_lib.route_topk(logits, k)
    aux = compat.all_reduce_sum(aux, group) / M

    # ---- stage 1: pack per-destination-rank capacity buffers -------------
    dest = topi.reshape(-1) // E_loc                     # (T*k,) rank id
    e_local = topi.reshape(-1) % E_loc
    w_flat = topw.reshape(-1)
    t_flat = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.sort(dest, stable=True).indices
    dest_s, e_s, w_s, t_s = dest[order], e_local[order], w_flat[order], \
        t_flat[order]
    counts = torch.bincount(dest_s, minlength=M)
    starts = torch.cumsum(counts, 0) - counts
    rank_slot = torch.arange(T * k, device=dev) - starts[dest_s]
    keep = rank_slot < Csend
    slot = torch.where(keep, dest_s * Csend + rank_slot, M * Csend)

    grid_tok = _scatter_ids(M * Csend, slot, t_s, T)
    grid_e = _scatter_ids(M * Csend, slot, e_s, E_loc)
    grid_w = torch.zeros((M * Csend + 1,), dtype=torch.float32, device=dev)
    grid_w[slot] = w_s
    grid_w = grid_w[:M * Csend]

    x_pad = torch.cat([x_loc, x_loc.new_zeros((1, d))], 0)
    buf_x = x_pad[grid_tok]                               # (M*Csend, d)

    # ---- hop 1: tokens to the ranks that own their experts ---------------
    rx = compat.all_to_all(buf_x, group)                  # (R, d)
    re = compat.all_to_all(grid_e, group)                 # E_loc = invalid

    # ---- local second-stage dispatch to E_loc experts --------------------
    R = M * Csend
    order2 = torch.sort(re, stable=True).indices
    re_s = re[order2]
    counts2 = torch.bincount(re_s, minlength=E_loc + 1)  # last bin: pads
    starts2 = torch.cumsum(counts2, 0) - counts2          # exclusive
    rank2 = torch.arange(R, device=dev) - starts2[re_s]
    keep2 = (re_s < E_loc) & (rank2 < C_loc)
    slot2 = torch.where(keep2, re_s * C_loc + rank2, E_loc * C_loc)
    if moe_lib.DROP_STATS is not None and count_drops:
        # pairs kept at this rank's experts, pairs this rank routed: summed
        # over the line, the share the two capacities keep
        moe_lib.DROP_STATS.append((keep2.sum(), T * k))

    grid2 = _scatter_ids(E_loc * C_loc, slot2, order2, R)
    rx_pad = torch.cat([rx, rx.new_zeros((1, d))], 0)
    expert_in = rx_pad[grid2].reshape(E_loc, C_loc, d)

    h = torch.nn.functional.silu(
        torch.bmm(expert_in, params["we1"].to(cdt))
    ) * torch.bmm(expert_in, params["we3"].to(cdt))
    expert_out = torch.bmm(h, params["we2"].to(cdt))

    # expert outputs back to buffer order (a gather: buffer row r reads the
    # slot that holds it, or the zero row), reverse hop
    buf_slot = torch.empty_like(slot2)
    buf_slot[order2] = slot2
    eo_pad = torch.cat([expert_out.reshape(E_loc * C_loc, d),
                        expert_out.new_zeros((1, d))], 0)
    back = compat.all_to_all(eo_pad[buf_slot], group)    # (M*Csend, d)

    # combine at source with the saved slot mapping + top-k weights: each
    # token gathers its k slots in ascending order (a dropped pair reads
    # the zero row M*Csend, last)
    contrib = back * grid_w[:, None].to(cdt)
    c_pad = torch.cat([contrib, contrib.new_zeros((1, d))], 0)
    tok_slot = torch.empty_like(slot)
    tok_slot[order] = slot
    tok_slot = torch.sort(tok_slot.reshape(T, k), dim=1).values
    out = torch.zeros((T, d), dtype=cdt, device=dev)
    for j in range(k):
        out = out + c_pad[tok_slot[:, j]]

    if cfg.moe_dense_residual:
        out = out + mlp(params["dense"], x_loc, cdt)
    return out, aux


def moe_ffn_a2a(params, cfg: ModelConfig, x: Tensor, *,
                count_drops: bool = True) -> Tuple[Tensor, Tensor]:
    """Global wrapper over the current joined grid. x: (B_loc, S, d), this
    rank's DP shard, the same on every rank of its 'model' line;
    ``params`` hold all experts, and each rank takes its shard under
    ``sharding.specs.param_spec`` (``P("model", None, None)``). Falls back
    to ``moe_ffn`` as the module docstring says."""
    grid = compat.current_grid()
    B, S, d = x.shape
    M = grid.axis_size("model") if grid is not None \
        and "model" in grid.axes else 1
    if grid is None or not grid.joined or M == 1 or S % M != 0:
        return moe_lib.moe_ffn(params, cfg, x, count_drops=count_drops)
    m = grid.index("model")
    group = grid.group("model")
    spec = specs.param_spec({key: params[key] for key in EXPERT_KEYS})
    local = dict(params)
    for key in EXPERT_KEYS:
        local[key] = specs.local_slice(params[key], spec[key], grid)
    Sl = S // M
    xl = x[:, m * Sl:(m + 1) * Sl].reshape(B * Sl, d)
    out, aux = moe_ffn_a2a_local(local, cfg, xl, group=group, M=M,
                                 count_drops=count_drops)
    others = tuple(a for a in grid.axes if a != "model")
    n_other = grid.axis_size(others) if others else 1
    if n_other > 1:
        # pmean over the other axes: a sum over all ranks counts each DP
        # shard's line mean M times
        aux = compat.all_reduce_sum(aux, None) / (n_other * M)
    out = compat.all_gather_cat(out.reshape(B, Sl, d), group, dim=1)
    return out, aux.float()


# ---------------------------------------------------------------------------
# a rank's run (the spawn target of the tests, the examples and the tools)
# ---------------------------------------------------------------------------

def _dp_rows(a, grid):
    """This rank's rows of a global batch (dim 0 split over the DP axes in
    row-major order, as ``P(("pod", "data"), ...)`` tiles it)."""
    dp = tuple(ax for ax in grid.axes if ax != "model")
    n = grid.axis_size(dp) if dp else 1
    i = grid.index(dp) if dp else 0
    per = a.shape[0] // n
    return a[i * per:(i + 1) * per]


def run_case(case: dict, grid, device) -> dict:
    """One case on this rank of the joined ``grid``: ``case["kind"]`` is
    "ffn" (``moe_ffn_a2a`` on the global x (B, S, d)), "forward" or
    "prefill" (``model.forward`` / ``decode.prefill`` on global tokens
    (B, S)); ``params`` are numpy trees (all experts; each rank takes its
    shard). Returns this rank's output, aux, the (kept, routed) pairs it
    saw, and the collectives it issued (recorded)."""
    from repro_torch import convert
    from repro_torch.models import decode, model
    from repro_torch.roofline import hlo

    cfg = case["cfg"]
    params = convert.lm_params(case["params"], device)
    moe_lib.DROP_STATS = []
    with hlo.CollectiveRecorder() as rec, torch.no_grad():
        if case["kind"] == "ffn":
            x = convert.tensor(_dp_rows(case["x"], grid), device,
                               cfg.compute_dtype)
            out, aux = moe_ffn_a2a(params, cfg, x)
        else:
            tokens = torch.from_numpy(
                _dp_rows(case["tokens"], grid)).long().to(device)
            aux = torch.zeros(())
            if case["kind"] == "forward":
                out, aux = model.forward(params, cfg, tokens=tokens)
            else:
                out, _ = decode.prefill(params, cfg, tokens=tokens,
                                        s_max=case["s_max"])
    stats, moe_lib.DROP_STATS = moe_lib.DROP_STATS, None
    kept = int(sum(int(k) for k, _ in stats))
    routed = int(sum(r for _, r in stats))
    return {"out": out.float(), "aux": float(aux), "kept": kept,
            "routed": routed, "ops": rec.ops}


def rank_cases(cases, device="cuda") -> list:
    """Spawn target (``compat.spawn``): run each case (:func:`run_case`) on
    its grid, ``case["grid"] = (shape, axes)``, joined over the current
    process group (each grid once, in the order the cases name them, the
    same on every rank)."""
    grids = {}
    out = []
    for case in cases:
        key = tuple(map(tuple, case["grid"]))
        if key not in grids:
            grids[key] = compat.join_grid(compat.make_grid(*key))
        grid = grids[key]
        with compat.use_grid(grid):
            out.append(run_case(case, grid,
                                compat.rank_device(device, grid.rank)))
    return out
