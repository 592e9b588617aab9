"""Unified model configuration covering all 10 assigned architectures; port
of ``repro/models/config.py`` with torch dtypes.

Families:
  dense   — GQA transformer (qwen3-8b/14b, command-r-35b, phi3-medium-14b)
  moe     — GQA transformer + MoE FFN (olmoe-1b-7b, arctic-480b w/ dense residual)
  rwkv6   — attention-free Finch (time-mix WKV + channel-mix)
  griffin — RG-LRU + local-attention hybrid (recurrentgemma-9b, 2:1 pattern)
  encdec  — encoder-decoder backbone (seamless-m4t-large-v2; audio stub)
The vlm entry (qwen2-vl-72b) is family=dense + mrope + vision stub.

The port runs every family on one card.
``remat`` picks what a training forward keeps for backward, as in the
reference: each layer runs under ``torch.utils.checkpoint`` (``"full"``
saves nothing inside a layer, ``"dots"`` saves the plain matmul outputs,
``"none"`` checkpoints nothing); it does nothing while grad is disabled.
``scan_layers``, ``unroll_inner``, ``sp_collectives``, ``fsdp`` and
``parallelism`` are compile-time or mesh knobs of the JAX package. They
are kept so that configurations carry over field for field, and they do
nothing on one card: the port runs eagerly, loops over layers in Python and
holds every tensor on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | rwkv6 | griffin | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False              # qwen2-vl M-RoPE (t/h/w sections)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # per half-dim
    attn_logit_softcap: float = 0.0
    kv_repeat: int = 1               # KV-head replication for TP alignment
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None   # expert hidden (defaults to d_ff)
    moe_dense_residual: bool = False # arctic: dense SwiGLU in parallel
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "gspmd"

    # griffin (RG-LRU hybrid)
    pattern: Tuple[str, ...] = ()    # e.g. ("rec", "rec", "attn")
    window_size: int = 2048          # local attention window
    lru_width: Optional[int] = None  # defaults to d_model
    conv_width: int = 4

    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 32
    wkv_chunk: int = 16
    wkv_impl: str = "matmul"

    # encdec
    encoder_layers: int = 0          # >0 => encoder-decoder
    cross_attention: bool = False

    # frontend stub: "none" | "audio" | "vision"
    frontend: str = "none"

    # numerics / training
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    optimizer: str = "adamw"         # adamw | adafactor (arctic)
    remat: str = "full"              # full | dots | none (module doc)
    # JAX compile-time and mesh knobs: no effect on one card (module doc)
    scan_layers: bool = True
    unroll_inner: bool = False
    sp_collectives: bool = True
    fsdp: bool = False
    parallelism: str = "tp"

    @property
    def dp_axes(self):
        return ("pod", "data", "model") if self.parallelism == "fsdp" \
            else ("pod", "data")

    # shapes this arch skips, with reasons (DESIGN.md §5)
    skip_shapes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "moe" and self.moe_d_ff is None:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.family == "griffin" and self.lru_width is None:
            object.__setattr__(self, "lru_width", self.d_model)

    # ------------------------------------------------------------------
    @property
    def kv_heads_eff(self) -> int:
        return self.num_kv_heads * self.kv_repeat

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        att = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        dense_ffn = 3 * d * self.d_ff
        per_layer = 0
        if self.family in ("dense", "moe"):
            per_layer = att + 2 * d  # norms
            if self.family == "dense":
                per_layer += dense_ffn
            else:
                per_layer += self.num_experts * 3 * d * self.moe_d_ff \
                    + d * self.num_experts
                if self.moe_dense_residual:
                    per_layer += dense_ffn
            total = emb + head + self.num_layers * per_layer
        elif self.family == "rwkv6":
            r = self.rwkv_lora_rank
            tmix = 4 * d * d + d * d  # r,k,v,g,w projections (w low-rank-ish)
            tmix += 5 * (d * r + r * d)  # ddlerp loras
            cmix = 2 * d * self.d_ff + 0
            per_layer = tmix + cmix + 2 * d
            total = emb + head + self.num_layers * per_layer
        elif self.family == "griffin":
            lw = self.lru_width
            rec = 2 * d * lw + lw * d + lw * self.conv_width + 2 * lw  # gates
            attn_l = att
            n_attn = sum(1 for i in range(self.num_layers)
                         if self._layer_kind(i) == "attn")
            n_rec = self.num_layers - n_attn
            total = emb + head + n_rec * (rec + dense_ffn + 2 * d) \
                + n_attn * (attn_l + dense_ffn + 2 * d)
        elif self.family == "encdec":
            dec = att + dense_ffn + 2 * d
            cross = att + d
            enc = att + dense_ffn + 2 * d
            total = emb + head + self.encoder_layers * enc \
                + self.num_layers * (dec + cross)
        else:
            raise ValueError(self.family)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only) for 6ND."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        inactive = (self.num_experts - self.experts_per_token) \
            * 3 * d * self.moe_d_ff * self.num_layers
        return int(self.param_count() - inactive)

    def _layer_kind(self, i: int) -> str:
        """griffin: layer i kind from the repeating pattern."""
        if self.family != "griffin" or not self.pattern:
            return "dense"
        return self.pattern[i % len(self.pattern)]
