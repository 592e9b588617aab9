"""repro_torch.engine — the per-iteration hot path (DESIGN.md section 8).

Public surface:
  * :class:`IterationEngine` — fused one-pass iteration body with
    reference / chunked / cuda backends and bf16 data residency;
  * :func:`gram_stats` — backend-dispatched one-pass (D^T D, D^T b);
  * :mod:`repro_torch.engine.autotune` — the shape-keyed block model.
"""
from repro_torch.engine import autotune
from repro_torch.engine.engine import (
    BACKENDS,
    KERNEL_KINDS,
    EngineStep,
    IterationEngine,
    default_backend,
    gram_stats,
)
from repro_torch.engine.streaming import SweepResult

__all__ = [
    "BACKENDS",
    "KERNEL_KINDS",
    "EngineStep",
    "IterationEngine",
    "SweepResult",
    "autotune",
    "default_backend",
    "gram_stats",
]
