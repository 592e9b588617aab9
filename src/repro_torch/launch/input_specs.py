"""Meta-device stand-ins for every model input, per (arch x shape) cell;
port of ``repro/launch/input_specs.py``.

Shapes (LM-family, per assignment):
  train_4k    : seq 4096,    global_batch 256   -> train_step
  prefill_32k : seq 32768,   global_batch 32    -> prefill
  decode_32k  : cache 32768, global_batch 128   -> serve_step (1 new token)
  long_500k   : state 524288, global_batch 1    -> serve_step (sub-quadratic
                families only; skips recorded per-config in skip_shapes)

Modality frontends are STUBS per the assignment: [vlm] cells get precomputed
patch embeddings + 3-stream M-RoPE position ids; [audio] cells get frame
embeddings for the encoder. Every tensor here lives on
``torch.device("meta")``, the port's counterpart of a
``jax.ShapeDtypeStruct``: shapes and dtypes, no memory.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import init_caches
from repro_torch.models.model import init_params

META = torch.device("meta")

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _train_or_prefill_inputs(cfg: ModelConfig, B: int, S: int, *,
                             with_labels: bool) -> Dict[str, Any]:
    batch: Dict[str, Any] = {}
    i32 = torch.int32
    if cfg.frontend == "vision":
        batch["embeds"] = sds((B, S, cfg.d_model), torch.bfloat16)
        batch["positions"] = sds((3, B, S), i32)
        if with_labels:
            batch["labels"] = sds((B, S), i32)
    elif cfg.frontend == "audio" or cfg.family == "encdec":
        # encoder frames stub at the same length as the decoder tokens
        batch["enc_embeds"] = sds((B, S, cfg.d_model), torch.bfloat16)
        batch["tokens"] = sds((B, S), i32)
        if with_labels:
            batch["labels"] = sds((B, S), i32)
    else:
        batch["tokens"] = sds((B, S), i32)
        if with_labels:
            batch["labels"] = sds((B, S), i32)
    return batch


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """Returns {"kind": train|prefill|decode, ...meta tensors...}."""
    meta = SHAPES[shape_name]
    B, S = meta["batch"], meta["seq"]
    kind = meta["kind"]
    if shape_name in cfg.skip_shapes:
        raise ValueError(f"{cfg.name} skips {shape_name} "
                         f"(see DESIGN.md §Arch-applicability)")
    if kind == "train":
        return {"kind": "train",
                "batch": _train_or_prefill_inputs(cfg, B, S,
                                                  with_labels=True)}
    if kind == "prefill":
        return {"kind": "prefill",
                "batch": _train_or_prefill_inputs(cfg, B, S,
                                                  with_labels=False),
                "s_max": S}
    if kind == "decode":
        # one new token against a seq-long cache/state
        s_enc = 4096 if cfg.family == "encdec" else 0
        caches = init_caches(cfg, B, S, s_enc=s_enc, dtype=torch.bfloat16,
                             device=META)
        return {"kind": "decode",
                "tokens": sds((B,), torch.int32),
                "pos": sds((), torch.int32),
                "caches": caches}
    raise ValueError(kind)


class _MetaFactories(TorchFunctionMode):
    """Every factory call that names a device makes its tensor on the meta
    device instead, and random ones drop their generator: ``init_params``
    then builds its tree of shapes and dtypes without memory or RNG."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs.pop("generator", None)
            kwargs["device"] = META
        return func(*args, **kwargs)


def abstract_params(cfg: ModelConfig, seed: int = 0):
    """Parameter shapes and dtypes as a tree of meta tensors (no
    allocation); ``seed`` is kept for the reference's signature."""
    del seed
    with _MetaFactories():
        return init_params(cfg, torch.Generator())
