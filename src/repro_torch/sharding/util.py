"""Grid-aware sharding helpers; port of ``repro/sharding/util.py``.

A spec is a plain tuple with one entry per dimension: an axis name, a tuple
of axis names, or None (the reference's ``PartitionSpec`` read as a
tuple). :func:`filter_spec` drops the axis names a grid does not have, so
the same spec serves a (data, model) grid and a (pod, data, model) one.

``shard()`` and ``named_sharding()`` have no counterpart: they are GSPMD
annotations (``with_sharding_constraint``, ``NamedSharding``) that ask the
compiler to place an array. Eager torch has no compiler to ask: a rank
holds what its own code cuts (``sharding.specs.local_slice``) and moves
what its own collectives move.
"""
from __future__ import annotations

from typing import Tuple

# Logical data-parallel axes in priority order; ('pod','data') on the
# multi-pod grid collapses to ('data',) on a single pod.
DP = ("pod", "data")
MODEL = "model"

Spec = Tuple


def _filter_entry(entry, axis_names):
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in axis_names else None
    # tuple of axes
    kept = tuple(a for a in entry if a in axis_names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def filter_spec(spec: Spec, axis_names) -> Spec:
    return tuple(_filter_entry(e, axis_names) for e in spec)
