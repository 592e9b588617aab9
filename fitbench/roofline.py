"""The yardstick's arithmetic: published peaks and the least time each
stage of a fit could take.

Frozen here so that a later change to the program cannot move it. A stage's
count sits in a file of its own, ``work/<stage>.py`` with ``count(m, n,
cfg) -> (bytes, operations)``, found by the name a configuration gives it
in ``fit_work``; a loss's prox is ``work/prox_<loss>.py`` with
``flops(cfg)``, operations a row. A new stage or loss is a new file. Each
input byte is counted once and each output byte once, whatever a kernel
reads again; the operations are those the algorithm needs for the call's
shapes. A stage's floor is the larger of its bytes over the memory rate and
its operations over the FP32 rate (the port's kernels run on the FP32
cores, not the tensor cores).
"""
from __future__ import annotations

from fitbench import manifest

# (HBM bytes/s, FP32 FLOP/s) by card name, NVIDIA's data sheets (dense
# rates, no sparsity). An H100 whose name matches neither PCIe nor NVL is
# the SXM part.
PEAKS = {"H100 PCIe": (2.0e12, 51e12),
         "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}


def peaks(device_name: str):
    """(HBM bytes/s, FP32 FLOP/s) of the first ``PEAKS`` key in the card's
    name; the H100 SXM's when none is."""
    for key, val in PEAKS.items():
        if key in device_name:
            return val
    return PEAKS["H100"]


def floor_s(nbytes: float, nflops: float, pk) -> float:
    """The least time: bytes over the memory rate or operations over the
    FP32 rate, whichever is larger."""
    bw, fp32 = pk
    return max(nbytes / bw, nflops / fp32)


def prox_flops(cfg: dict) -> int:
    """Operations per row of the configuration's prox."""
    return manifest.module("work", f"prox_{cfg['loss']}").flops(cfg)


def stage(name: str, m: int, n: int, cfg: dict):
    """(bytes, operations) of one stage of a fit on m rows of n features."""
    return manifest.module("work", name).count(m, n, cfg)


def fit_floor_s(cfg: dict, m: int, n: int, iters: int, pk) -> float:
    """The least time of one fit of ``iters`` iterations on m rows: each
    stage of ``cfg["fit_work"]`` at its own floor, those under "once" once
    and those under "per_iter" every iteration."""
    work = cfg["fit_work"]
    once = sum(floor_s(*stage(s, m, n, cfg), pk) for s in work["once"])
    each = sum(floor_s(*stage(s, m, n, cfg), pk) for s in work["per_iter"])
    return once + iters * each
