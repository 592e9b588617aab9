"""repro_torch.cluster — the multi-process coordinator/worker runtime
(DESIGN.md section 11); port of ``repro.cluster``.

  * :mod:`compress`    — int8 error-feedback wire compression, shared
                         with ``core/distributed.py``'s all-reduce;
  * :mod:`transport`   — length-prefixed socket framing + byte counters;
  * :mod:`reduction`   — per-iteration contribution container and the
                         tree-reduce topology;
  * :mod:`membership`  — worker registry, heartbeats, block ownership,
                         reassignment and rebalance plans;
  * :mod:`chaos`       — seeded, deterministic fault injection (wire /
                         process / membership faults);
  * :mod:`worker`      — the worker process: owns store row blocks, runs
                         the fused iteration body on its device, ships
                         reductions;
  * :mod:`coordinator` — the solver node: global x-update, broadcast,
                         fault recovery, bounded-staleness aggregation.

``compress`` is imported eagerly (``core/distributed`` depends on it);
the runtime modules load lazily so importing :mod:`repro_torch.core`
never pays for the cluster machinery.
"""
from repro_torch.cluster import compress  # noqa: F401  (eager)
from repro_torch.cluster.compress import (
    DEFAULT_BLOCK,
    dequantize_int8,
    ef_compress,
    quantize_int8,
    wire_bytes,
)

_LAZY = {
    "ChaosSchedule": "repro_torch.cluster.chaos",
    "ClusterConfig": "repro_torch.cluster.coordinator",
    "ClusterCoordinator": "repro_torch.cluster.coordinator",
    "ClusterResult": "repro_torch.cluster.coordinator",
    "DegradePolicy": "repro_torch.cluster.coordinator",
    "FaultInjector": "repro_torch.cluster.chaos",
    "cluster_solve": "repro_torch.cluster.coordinator",
    "cluster_stats": "repro_torch.cluster.coordinator",
}

__all__ = ["DEFAULT_BLOCK", "compress", "dequantize_int8", "ef_compress",
           "quantize_int8", "wire_bytes"] + sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
