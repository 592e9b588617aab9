"""Serve step builder; port of ``make_serve_step`` in
``repro/runtime/steps.py``. The train step (loss -> grads -> optimizer) is
still to port (ROADMAP section 1, item 11)."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import decode_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, caches, tokens, pos):
        return decode_step(params, cfg, caches, tokens=tokens, pos=pos)
    return serve_step
