"""Unified LM covering every family: init / forward / loss; port of
``repro/models/model.py``.

Param tree layout (the reference's pytree, one to one; every segment of the
stack carries a leading L axis):
  {embed, blocks, final_norm, lm_head [, enc_blocks, enc_norm]}
``blocks`` is a list with one dict per homogeneous segment of layer kinds.

Layer kinds: ``"attn"`` (dense), ``"moe"``, ``"rwkv"``, ``"rec"`` and
``"attn_local"`` (griffin) and ``"cross"`` (the encoder-decoder's decoder
layer); the encoder is a stack of ``"attn"`` layers run without the causal
mask. The reference's ``shard(...)`` annotations, its ``gather_in`` /
``scatter_out`` and its scan / remat are mesh and compile-time devices and
have no counterpart on one card: ``_run_stack`` is a Python loop over the
stacked layers.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import griffin as griffin_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    attention,
    dense_init,
    init_attention,
    init_mlp,
    mlp,
    rmsnorm,
)

Tensor = torch.Tensor


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nest of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map2(fn, a, b):
    """``fn(x, y)`` over matching tensors of two nests of dicts and lists."""
    if isinstance(a, dict):
        for key in a:
            tree_map2(fn, a[key], b[key])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            tree_map2(fn, x, y)
    else:
        fn(a, b)


# ---------------------------------------------------------------------------
# Block init / apply (one layer)
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str):
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=cfg.param_dtype,
                                device=gen.device)
    p: Dict[str, Any] = {"ln1": zeros(), "ln2": zeros()}
    if kind in ("attn", "attn_local"):
        p["attn"] = init_attention(gen, cfg)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.param_dtype)
    elif kind == "moe":
        p["attn"] = init_attention(gen, cfg)
        p["moe"] = moe_lib.init_moe(gen, cfg)
    elif kind == "rwkv":
        p["tmix"] = rwkv_lib.init_time_mix(gen, cfg)
        p["cmix"] = rwkv_lib.init_channel_mix(gen, cfg)
    elif kind == "rec":
        p["rec"] = griffin_lib.init_recurrent_block(gen, cfg)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.param_dtype)
    elif kind == "cross":  # encoder-decoder decoder layer
        p["attn"] = init_attention(gen, cfg)
        p["ln_x"] = zeros()
        p["xattn"] = init_attention(gen, cfg)
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.param_dtype)
    else:
        raise ValueError(kind)
    return p


def cross_kv(xa, cfg: ModelConfig, enc_out: Tensor):
    """Cross-attention keys and values: the encoder output through the
    layer's own ``wk`` / ``wv``, no RoPE. (B, Se, Hkv_eff, hd) each."""
    cdt = cfg.compute_dtype
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.kv_heads_eff, cfg.head_dim)
    return ((enc_out @ xa["wk"].to(cdt)).reshape(shape),
            (enc_out @ xa["wv"].to(cdt)).reshape(shape))


def _apply_block(params, cfg: ModelConfig, kind: str, x: Tensor,
                 positions: Tensor, *, causal: bool = True,
                 enc_out: Optional[Tensor] = None,
                 attn_impl: str = "cuda",
                 wkv_impl: str = "cuda") -> Tuple[Tensor, Tensor]:
    """Returns (x_out, aux_loss)."""
    eps = cfg.norm_eps
    cdt = cfg.compute_dtype
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("attn", "moe", "attn_local", "cross"):
        # attn_local has a window, which K4 does not take: the chunked
        # path, as in the reference
        window = cfg.window_size if kind == "attn_local" else 0
        x = x + attention(params["attn"], cfg,
                          rmsnorm(x, params["ln1"], eps), positions,
                          causal=causal, window=window, attn_impl=attn_impl)
        if kind == "cross":
            # cross-attention: kv from encoder output (own projections).
            xa = params["xattn"]
            x = x + attention(xa, cfg, rmsnorm(x, params["ln_x"], eps),
                              positions, causal=False,
                              kv_override=cross_kv(xa, cfg, enc_out),
                              attn_impl=attn_impl)
        ff_in = rmsnorm(x, params["ln2"], eps)
        if kind == "moe":
            # moe_impl "a2a" (olmoe, arctic): the reference's moe_ffn_a2a
            # takes moe_ffn when there is no mesh, which one card is
            h, aux = moe_lib.moe_ffn(params["moe"], cfg, ff_in)
        else:
            h = mlp(params["mlp"], ff_in, cdt)
        return x + h, aux
    if kind == "rwkv":
        h, _ = rwkv_lib.time_mix(params["tmix"], cfg,
                                 rmsnorm(x, params["ln1"], eps),
                                 wkv_impl=wkv_impl)
        x = x + h
        h, _ = rwkv_lib.channel_mix(params["cmix"], cfg,
                                    rmsnorm(x, params["ln2"], eps))
        return x + h, aux
    if kind == "rec":
        h, _ = griffin_lib.recurrent_block(params["rec"], cfg,
                                           rmsnorm(x, params["ln1"], eps))
        x = x + h
        h = mlp(params["mlp"], rmsnorm(x, params["ln2"], eps), cdt)
        return x + h, aux
    raise ValueError(kind)


def layer_kinds(cfg: ModelConfig, role: str = "decoder") -> Tuple[str, ...]:
    """Per-layer kind list for the given config."""
    if role == "encoder":
        return ("attn",) * cfg.encoder_layers
    if cfg.family == "dense":
        return ("attn",) * cfg.num_layers
    if cfg.family == "moe":
        return ("moe",) * cfg.num_layers
    if cfg.family == "rwkv6":
        return ("rwkv",) * cfg.num_layers
    if cfg.family == "griffin":
        pat = cfg.pattern or ("rec", "rec", "attn_local")
        return tuple(pat[i % len(pat)] for i in range(cfg.num_layers))
    if cfg.family == "encdec":
        return ("cross",) * cfg.num_layers
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def segment_structure(kinds: Tuple[str, ...]) -> Tuple[Tuple[str, int], ...]:
    """Maximal homogeneous runs of layer kinds: ((kind, count), ...)."""
    segs = []
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        segs.append((kinds[i], j - i))
        i = j
    return tuple(segs)


def _stack_init(gen: torch.Generator, cfg, kinds: Tuple[str, ...]):
    """Init a stack as a list of stacked segment trees (leading L axis per
    segment), matching segment_structure(kinds). Each segment is allocated
    once and filled layer by layer, so init holds one layer's temporaries."""
    out = []
    for kind, count in segment_structure(kinds):
        first = _init_block(gen, cfg, kind)
        seg = tree_map(lambda a: a.new_empty((count,) + a.shape), first)
        for li in range(count):
            layer = first if li == 0 else _init_block(gen, cfg, kind)
            tree_map2(lambda dst, src: dst[li].copy_(src), seg, layer)
        out.append(seg)
    return out


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``gen.device`` (the caller picks the device by
    the generator it passes; a different stream from the reference's)."""
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab_size, d), cfg.param_dtype,
                            scale=1.0),
        "final_norm": torch.zeros((d,), dtype=cfg.param_dtype,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size),
                                       cfg.param_dtype)
    params["blocks"] = _stack_init(gen, cfg, layer_kinds(cfg))
    if cfg.encoder_layers:
        params["enc_blocks"] = _stack_init(gen, cfg,
                                           layer_kinds(cfg, "encoder"))
        params["enc_norm"] = torch.zeros((d,), dtype=cfg.param_dtype,
                                         device=gen.device)
    return params


# ---------------------------------------------------------------------------
# Forward (train / prefill / encoder)
# ---------------------------------------------------------------------------

def _run_stack(segments, seg_meta, cfg: ModelConfig, x: Tensor,
               positions: Tensor, *, causal: bool, enc_out=None,
               attn_impl: str = "cuda", wkv_impl: str = "cuda"):
    """Each homogeneous segment, layer by layer."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (kind, count), stacked in zip(seg_meta, segments):
        for li in range(count):
            lp = tree_map(lambda a: a[li], stacked)
            x, a = _apply_block(lp, cfg, kind, x, positions, causal=causal,
                                enc_out=enc_out, attn_impl=attn_impl,
                                wkv_impl=wkv_impl)
            aux_total = aux_total + a
    return x, aux_total


def embed_tokens(params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    """Rows of the embedding in the compute type. The reference casts the
    whole table and then gathers; gathering first gives the same values
    without a (V, d) temporary."""
    return params["embed"][tokens].to(cfg.compute_dtype)


def encode(params, cfg: ModelConfig, enc_embeds: Optional[Tensor], *,
           attn_impl: str = "cuda") -> Optional[Tensor]:
    """The encoder's output (B, Se, d), or None for a decoder-only
    config: the ``"attn"`` stack without the causal mask, then
    ``enc_norm``."""
    if not cfg.encoder_layers:
        return None
    if enc_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                         "enc_embeds")
    Be, Se, _ = enc_embeds.shape
    enc_pos = torch.arange(Se, device=enc_embeds.device).expand(Be, Se)
    enc_x, _ = _run_stack(params["enc_blocks"],
                          segment_structure(layer_kinds(cfg, "encoder")),
                          cfg, enc_embeds.to(cfg.compute_dtype), enc_pos,
                          causal=False, attn_impl=attn_impl)
    return rmsnorm(enc_x, params["enc_norm"], cfg.norm_eps)


def forward(params, cfg: ModelConfig, *, tokens: Optional[Tensor] = None,
            embeds: Optional[Tensor] = None,
            positions: Optional[Tensor] = None,
            enc_embeds: Optional[Tensor] = None,
            attn_impl: str = "cuda",
            wkv_impl: str = "cuda") -> Tuple[Tensor, Tensor]:
    """Returns (final hidden states (B,S,d), aux_loss). Decoder-causal.

    ``attn_impl="cuda"`` (the default) runs the flash kernel K4 on CUDA
    tensors and its plain version on CPU tensors; ``"xla"`` the chunked
    path. The reference defaults to its chunked path only because Pallas
    does not lower on its CPU backend. ``wkv_impl`` chooses the same way
    for the rwkv layers: ``"cuda"`` the WKV kernel K5, ``"xla"`` the
    reference's chunked form (``cfg.wkv_impl``).

    encdec: enc_embeds (stub audio frames) run through the encoder; the
    decoder cross-attends to the encoder output.
    """
    if embeds is None:
        embeds = embed_tokens(params, cfg, tokens)
    B, S, d = embeds.shape
    if positions is None:
        positions = torch.arange(S, device=embeds.device).expand(B, S)
    enc_out = encode(params, cfg, enc_embeds, attn_impl=attn_impl)
    x, aux = _run_stack(
        params["blocks"], segment_structure(layer_kinds(cfg)),
        cfg, embeds, positions, causal=True, enc_out=enc_out,
        attn_impl=attn_impl, wkv_impl=wkv_impl,
    )
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# Loss: chunked cross-entropy (+ router aux + z-loss)
# ---------------------------------------------------------------------------

def chunked_cross_entropy(h: Tensor, lm_head: Tensor, labels: Tensor,
                          chunk: int = 512, z_coef: float = 1e-4) -> Tensor:
    """h: (B,S,d) final hiddens; lm_head: (d,V); labels (B,S).

    The (B, chunk, V) logits are formed per chunk in f32 and dropped after
    it: peak logits memory is B*chunk*V instead of B*S*V.
    """
    B, S, d = h.shape
    nchunks = S // chunk if S % chunk == 0 else 1
    if S % chunk != 0:
        chunk = S
    head = lm_head.float()
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    zl = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nchunks):
        hc = h[:, c * chunk:(c + 1) * chunk]
        lc = labels[:, c * chunk:(c + 1) * chunk]
        logits = hc.float() @ head
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        nll = nll + (lse - gold).sum()
        zl = zl + (lse ** 2).sum()
        del logits
    ntok = B * S
    return nll / ntok + z_coef * zl / ntok


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Tensor],
            attn_impl: str = "cuda",
            wkv_impl: str = "cuda") -> Tuple[Tensor, Dict[str, Tensor]]:
    h, aux = forward(
        params, cfg,
        tokens=batch.get("tokens"),
        embeds=batch.get("embeds"),
        positions=batch.get("positions"),
        enc_embeds=batch.get("enc_embeds"),
        attn_impl=attn_impl,
        wkv_impl=wkv_impl,
    )
    lm_head = params["lm_head"] if "lm_head" in params \
        else params["embed"].T
    ce = chunked_cross_entropy(h, lm_head, batch["labels"],
                               chunk=2048 if cfg.unroll_inner else 512)
    total = ce + cfg.router_aux_coef * aux
    return total, {"ce": ce, "aux": aux}
