#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --skip-main  # build and the kernel checks only

Phases (any failed check exits non-zero; no phase catches its own failure):

1. device   — prints ``nvidia-smi``'s name and power limit of the card.
2. build    — compiles the kernels from ``src/repro_torch/kernels/csrc``.
3. kernels  — each kernel (K1 prox, K2a gram, K2b gram+rhs, K3 admm_iter,
              K4 flash attention, K5 wkv) against its plain PyTorch version
              on the card at ragged shapes, f32 and bf16, all five prox
              kinds, K1's logistic chain on a hard grid (|z| to 1000,
              deltas 1e-3 to 1e3, labels -1, 0, 1; also against the mirror
              of its chain and the float64 root), K2a on a row-offset view (the same bits as on an
              aligned copy), K3's two routes (the
              ring for n <= 512; the wide kernel past it and pinned at
              n = 307), K4's GQA groups, head dims and masks on both routes
              (bf16 tensor cores; FMA, head dims 8-128), each K3 and K4
              call's route read
              from the counters, the tensor-core cases also against the plain
              version with P rounded to bf16, K5's head dims,
              chunks, layouts, final state and hard decay, and two
              identical calls compared bit for bit; K6 (the sparse
              iteration) against its plain version over all five kinds,
              f32 and bf16 values, want_dual on and off, a tail block,
              zero-nnz rows and an all-zero block, duplicate column ids,
              and u in shared memory and outside it, bit for bit across
              two calls; then a small solve, cuda backend against
              reference backend.
4. main     — the main path at full size: the star-catalog logistic problem
              (m = 16,777,216 rows x n = 307 features, f32, 20.6 GB on the
              card) solved by ``UnwrappedADMM.solve`` on the cuda backend,
              again with bf16 residency, and the SVM row of the fit table.
              The launch counters are set to 0 just before and read just
              after (K3: all 600 on the ring route); x is held against the
              reference backend on the card.
5. timing   — each kernel at the main path's shapes against its plain
              version: median of CUDA-event times, its bound on this card,
              and the library yardstick where one PyTorch call computes the
              same function (K2a must beat ``D.T @ D``, K2b
              ``D.T @ [D | a]``; both are held to a float64 Gram); K3 on
              both routes
              at the f32 shape and on the bf16 copy (the ring must beat the
              wide kernel in f32), with the hinge prox beside the logistic
              one; probes (printed): K1's blocks per SM, and every ring
              grid K3 takes, f32 and bf16.
   The ADMM tensors are then freed.
6. problems — the problem surface at the paper's lasso (section 10.1 /
              Fig. 1c: 320 nodes x 50,000 rows x 200 features,
              heterogeneous, 12.8 GB f32) through ``fit()``: lasso (method
              transpose and its fasta alias), ridge, elastic_net and nnls,
              one K2b launch each (counted: 5), then FASTA or a Cholesky
              solve on the 200 x 200 Gram; K2b's (G, c) and each x held
              against float64; the consensus baseline on the same data
              (time to model against transpose). Then every registry key
              and every executor problem at N 4 x m_i 250 x n 20 on the
              card against the same call on the CPU, and K2b timed at the
              lasso's shape against its plain version and D.T @ [D | b].
              Then phase 14 (the fit service) on the same data.
   The lasso data are freed.
7. sparse   — the sparse data path (DESIGN.md section 10) at n = 512
              features, density 1 %, m = 2^22 rows, f32 values (~0.9 GB
              as a BlockCSR on the card; 8.6 GB dense): the logistic
              problem solved by ``UnwrappedADMM.solve`` through K6 (its
              count set to 0 just before and read just after: one launch
              per iteration), again with bf16 residency, and the SVM row;
              x held against the densify oracle (backend "reference") on
              the card and against float64; K6 timed against its plain
              version and its byte bound (f32 and bf16), with K3 on the
              densified copy as a printed probe. Then the CLI
              (``launch.fit.main --density 0.01``) for logistic and lasso
              at 2^20 rows, and the column-split dual lasso (paper section
              7.1) at m = 2,048 x n = 262,144 (32 nodes of 8,192 columns):
              one K2a launch for the Gram of D_hat = [I; D^T], 3000
              iterations, the certificates of tests/test_column_split.py,
              and K2a timed at D_hat's shape against ``D_hat.T @ D_hat``.
   The sparse data are freed.
8. ooc      — the out-of-core path (DESIGN.md section 9). The star catalog
              (16,777,216 x 307 f32, halved if the host has under 64 GiB
              available) made on the card and copied to a host
              ``ShardedMatrixStore`` whose block height fits a 4096 MiB
              device budget (20 blocks of 870,128 rows, the tail padded):
              ``solve_streaming`` for 20 iterations (Gram: one K2a launch
              per block; K3 counted: blocks x iterations) against the
              in-memory ``solve`` on the same D (x 1e-4, objective 1e-5),
              overlap on and off bit for bit, the peak device memory
              against the budget, and one sweep's streams timed apart
              (double-buffered, naive, transfer only, host staging,
              compute only, beside a 1 GiB pinned H2D); K3 timed at the
              store-block shape. Then a checkpointed solve at 2^20 rows
              resumed bit for bit (a checkpoint of another store refused),
              phase 7's CLI data (2^20 x 512 at 1 %) in a sparse store
              through K6 (one launch per block per iteration) against the
              in-memory sparse solve, K6 timed at the store-block shape,
              ``SufficientStats.from_store`` on the lasso at 4,194,304 x
              200 (one K2b launch per block) with FASTA on it and the
              Cholesky update / downdate of a 256-row block, and
              ``launch.fit.main --executor streaming`` with checkpoints,
              then ``--resume``, at 2^20 rows.
9. shard_map — runs right after phase 5, while phase 4's star catalog is
              still on the card: the shard_map path (rows over the ranks of
              a process group, ``ShardMapExecutor`` under the shared driver)
              at world 1 on NCCL, and at worlds 2 and 4 on gloo with every
              rank on the one card (world 2 also with int8 error-feedback
              compression). D is shared with the ranks by CUDA IPC, so it
              lives once on the card and each rank takes a view of its
              rows. Each is a logistic solve (tau 0.1, at most 200
              iterations, Boyd's rule): x bitwise equal on every rank and
              held to the local solve's x (1e-5, compressed 1e-3), each
              rank's K2a and K3 counts set to 0 just before and read just
              after (1 and the iterations, K3 all on the ring); printed:
              ms/iter beside the local solve's, the reduction's time per
              iteration apart from K3, the setup, the peak device memory
              per rank, the iterations. Then K3 at the world-4 shard's
              shape (m / 4 rows) against its plain version. Then, still on
              phase 4's D, ``UnwrappedADMM.solve`` for 20 iterations with
              observability off and on: x bit-identical, 20 telemetry
              records.
10. cluster — the cluster runtime (DESIGN.md section 11), after phase 8,
              on its data saved to a directory (tmpfs when it has room) and
              memory-mapped by worker processes that share the card; the
              in-RAM copy is freed first. The star catalog in phase 8's 20
              blocks over 4 workers for 20 iterations with observability
              on: x held to phase 8's in-memory x (1e-5), the workers'
              K3 (all on the ring, blocks x iterations) and K2b (one per
              block) launches counted in each worker and summed from their
              telemetry, the workers' block_step and worker_iter spans
              under the coordinator's collect spans in the merged trace,
              20 telemetry records stamped cluster, obs_report on the
              directory. Then at the first 4,194,304 rows (8 blocks): a
              worker SIGKILLed at iteration 8 (reassigned, x 1e-5 from the
              in-memory x) and 2 workers with int8 compression (objective
              2e-2 from the plain one, under 3 x 4 x n bytes an iteration);
              ``cluster_stats`` on phase 8's lasso store against float64;
              the CLI ``--executor cluster --workers 2 --obs-dir`` at 2^20
              x 200 and obs_report on its directory. Printed: ms/iter (the
              driver's init to its finish), collect time, block_step p50,
              reduction bytes, spawn and register time, host staging rate,
              peak device memory per worker, the phase's seconds.
   The LM slices run in turn (f32 weights, random from the seed; each
   freed before the next): qwen3-8b, rwkv6-1.6b, olmoe-1b-7b,
   recurrentgemma-9b and seamless-m4t-large-v2 at full width and depth,
   qwen2-vl-72b at full width and 4 of its 80 layers; each phase prints its
   seconds:
11. lm main — ``forward`` at B 2 x S 4096 (rwkv6: B 8 x T 4096) and
              ``loss_fn``, with the kernel's count set to 0 just before and
              read just after: K5 once an rwkv layer; K4 once a layer with
              unwindowed attention, once more a cross attention and once an
              encoder layer (olmoe 16, seamless 72, qwen2-vl 4 a forward,
              recurrentgemma 0: its attention is local, the chunked path),
              per route (bf16: all on the tensor-core kernel); the inputs
              per family (stub frames for the encoder-decoder; stub patch
              embeddings at the M-RoPE positions of a 4 x 32 x 32 grid for
              the VLM); ``forward`` on the chunked path against it (bf16:
              fixed bounds, or the nudged-input control for rwkv6 and MoE);
              prefill plus 4 decode steps against ``forward``'s logits;
              MoE: the share of (token, expert) pairs dropped at capacity
              1.25 and a second forward bit for bit; then the same at full
              width, 2-4 layers and f32 compute with tight bounds (K4 all
              on the FMA route; MoE at capacity 8, where decode drops
              nothing).
12. serve   — ``repro_torch.launch.serve.main`` at batch 8, prompt 2048,
              64 generated tokens (qwen2-vl with ``--layers 4``): prefill
              seconds, decode ms/step and tok/s beside the weight-read
              floor, K4 in prefill only for the encoder (24 launches), K5
              in every rwkv layer; MoE drop shares in prefill and decode.
13. timing  — K4 at each LM's shape against its plain version and
              ``scaled_dot_product_attention`` (qwen3-8b: B 2, Hq 32, Hkv
              16, S 4096, D 128, causal, and the FMA route on f32 copies;
              olmoe, seamless (full, D 64) and qwen2-vl records of their
              own); K5 at the rwkv lm shape (B 8, H 32, T 4096, hd 64,
              chunk 16, bf16 r/k/v) against its plain version and the
              model's torch chunked form (K5 must beat it); one MoE FFN
              against its expert products alone; the RG-LRU doubling scan
              in f32 at (2, 4096, 4096) against a sequential recurrence,
              timed beside ``rg_lru`` and the recurrent block.
   Then the smoke configs of arctic-480b, qwen3-14b, phi3-medium-14b and
   command-r-35b: ``forward`` in bf16 (K4's FMA route at head dims 8 and
   16, counted), then f32 against the chunked path and prefill + decode
   against forward; K4 at head dim 8 timed (record
   ``K4_flash_attention_d8``).
14. service — the fit service (DESIGN.md section 15), run inside phase 6
              on its lasso before the data are freed: ``FitServer``
              registers D (one K2b launch, counted; the seconds split into
              K2b and the sha256 fingerprint), 64 ridge probes with fresh
              labels in windows of 16 (4 rhs passes, 1 factorization, no
              Gram pass; x against the float64 closed form; one window's
              H2D, rhs pass and triangular solve timed apart), a lasso path
              of 64 mus in one lane-batched FASTA (each lane against its
              single solve; KKT in float64), a logistic full solve (K3
              counted: 50 launches on the ring, K2a 1; x against
              ``UnwrappedADMM.solve``; K3 timed at the lasso's shape),
              ``FitFrontend`` on loopback with two
              tenants (48 requests, all ok, none lost; then 24 with seeded
              slow-backend chaos: degraded answers, none lost), a 64-row
              block ingested and retired (one K2b launch each, the rank-64
              factor update against a fresh factor, the fingerprint back
              to the original) and ``launch.serve_fit.main`` at 2^20 x 200
              in process (probes, ``--mu-path``) and with ``--port 0``.

15. train   — LM training (ROADMAP item 11.3), last, once the LM phases'
              weights are freed. Every arch's smoke config in f32: one
              ``make_train_step`` step on the card against the same step on
              the CPU from the same parameters and the token pipeline's
              batch (loss 1e-5 and grad norm 1e-4 relative, parameters
              1e-5, except those whose AdamW gradient is within 100 eps of
              0, held to 2 lr), and again on the card, bit for bit; as
              published (bf16), 8 steps on a fixed batch, the
              loss must fall. K4 and K5 raise under grad with an input
              that requires grad. ``launch.train`` in subprocesses with
              ``--device cuda``: uninterrupted, and killed at step 12 then
              resumed (qwen3-8b smoke, 24 steps, checkpoints every 8):
              final losses within rtol 1e-5, bitwise equality printed.
              rwkv6-1.6b at full width and depth through
              ``launch.train.main``, B 8 x T 512, remat full, 12 steps: the
              median step ms after two, tok/s, the peak device memory, the
              first and last loss (finite, falling); one more step under
              ``torch.profiler`` for the card's busy time. The train path
              runs the chunked attention and WKV forms: no kernel launches.

16. a2a     — all-to-all expert parallelism (``models/moe_a2a.py``), after
              the LM phases, before training: olmoe-1b-7b at full width
              and depth on a (1 data x 4 model) grid of gloo ranks sharing
              the card (the weights shared by CUDA IPC; each rank takes a
              view of its 16 experts). The single-rank forward (B 2 x S
              4096, capacity 8: nothing can drop) records each MoE layer's
              input and routing. One MoE layer in f32 at that shape, the
              one whose input ``moe_ffn`` drops most of at capacity 1.25:
              its local body at capacities under which nothing can drop,
              against ``moe_ffn_dense_ref`` on the card (1e-4 relative,
              routing flips counted apart and bounded); ``moe_ffn_a2a`` at
              the config's 1.25, against the same layer on the same gloo
              ranks computing on the CPU, 2 threads a rank (output and
              dropped pairs; the drop share printed). Then
              ``model.forward`` with ``moe_impl="a2a"`` in bf16 on the
              ranks, at the least capacity factor whose two stages hold
              the single-rank routing (x 1.1), every pair kept (counted),
              K4 16 launches a rank on the tensor-core route, timed (ms a
              forward, the slowest rank), the recorder's token-hop bytes a
              layer against 2 x Csend x M x d x 2; its logits against the
              single-rank forward's, free (printed) and with the experts
              pinned to the single rank's (held to the dense families'
              fixed bounds). Then the dry-run's roofline terms of the
              star_f32 fit cell, and of the main path's shape at world 1
              beside phase 4's ms/iter and K3's bound.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. The script imports no JAX and nothing of
the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

M_MAIN = 16_777_216          # rows of the main-path problem
ITERS = 200                  # iteration cap of the main-path solves
REPS = 10                    # timed calls per kernel (median)
SEED = 0
KINDS = ("logistic", "hinge", "l1", "least_squares", "quantile")


def logistic_flops(delta: float, newton_iters: int = 3) -> int:
    """FP32 operations per element of the logistic prox of csrc/prox.cuh
    (an exp, a reciprocal or a division counts as one): the bracket 13 (one
    exp), a bisection step 10 (one exp; ceil(log2 delta) of them), the
    start and 1/delta 7, a Newton step 14 (one exp, two divisions; 5 less
    the clamped steps, at least 2), a clamped Newton step of the reference
    18. At delta = 10, 3 clamped steps: 13 + 40 + 7 + 28 + 54 = 142."""
    nb = math.ceil(math.log2(delta)) if delta > 1 else 0
    return 13 + 10 * nb + 7 + 14 * max(2, 5 - newton_iters) \
        + 18 * newton_iters


# FP32 operations per element of the prox, the logistic one at the main
# path's delta = 1 / tau = 10
PROX_FLOPS = {"logistic": logistic_flops(10.0), "hinge": 8, "l1": 6,
              "least_squares": 6, "quantile": 10}
SOURCES = {
    "K1_prox_update": ("src/repro_torch/kernels/csrc/prox.cu",
                       "src/repro/kernels/prox/prox.py:76"),
    "K2a_gram": ("src/repro_torch/kernels/csrc/gram.cu",
                 "src/repro/kernels/gram/gram.py:149"),
    "K2b_gram_and_rhs": ("src/repro_torch/kernels/csrc/gram.cu",
                         "src/repro/kernels/gram/gram.py:101"),
    # K2b on the lasso path (r = 1, n = 200)
    "K2b_gram_and_rhs_lasso": ("src/repro_torch/kernels/csrc/gram.cu",
                               "src/repro/kernels/gram/gram.py:101"),
    "K3_admm_iter": ("src/repro_torch/kernels/csrc/admm_iter.cu",
                     "src/repro/kernels/admm_iter/admm_iter.py:82"),
    # bf16 at D 64 / 128, the main path's route; f32 and D 8 / 16 take
    # csrc/flash_attn.cu (timed beside it, printed); then K4 at the other
    # LMs' shapes, and at head dim 8 on the FMA route
    "K4_flash_attention": ("src/repro_torch/kernels/csrc/flash_attn_sm90.cu",
                           "src/repro/kernels/flash_attn/flash_attn.py:80"),
    "K4_flash_attention_olmoe": (
        "src/repro_torch/kernels/csrc/flash_attn_sm90.cu",
        "src/repro/kernels/flash_attn/flash_attn.py:80"),
    "K4_flash_attention_seamless": (
        "src/repro_torch/kernels/csrc/flash_attn_sm90.cu",
        "src/repro/kernels/flash_attn/flash_attn.py:80"),
    "K4_flash_attention_qwen2_vl": (
        "src/repro_torch/kernels/csrc/flash_attn_sm90.cu",
        "src/repro/kernels/flash_attn/flash_attn.py:80"),
    "K4_flash_attention_d8": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                              "src/repro/kernels/flash_attn/flash_attn.py:80"),
    "K5_wkv": ("src/repro_torch/kernels/csrc/wkv.cu",
               "src/repro/kernels/wkv/wkv.py:67"),
    # not the port of a Pallas kernel: the reference's sparse iteration is
    # a lax.scan of jnp gathers
    "K6_sparse_admm_iter": ("src/repro_torch/kernels/csrc/spgram.cu",
                            "src/repro/kernels/spgram/spgram.py:96"),
    # K2a on the column split's path, at D_hat's shape
    "K2a_gram_column_split": ("src/repro_torch/kernels/csrc/gram.cu",
                              "src/repro/kernels/gram/gram.py:149"),
    # K3 and K6 on the out-of-core path, at the store-block shapes
    "K3_admm_iter_store_block": ("src/repro_torch/kernels/csrc/admm_iter.cu",
                                 "src/repro/kernels/admm_iter/admm_iter.py:82"),
    "K6_sparse_admm_iter_store_block": (
        "src/repro_torch/kernels/csrc/spgram.cu",
        "src/repro/kernels/spgram/spgram.py:96"),
    # K3 on the shard_map path, at the world-4 shard (m / 4 rows)
    "K3_admm_iter_shard": ("src/repro_torch/kernels/csrc/admm_iter.cu",
                           "src/repro/kernels/admm_iter/admm_iter.py:82"),
    # K3 on the fit service's logistic full solve, at the lasso's shape
    "K3_admm_iter_lasso": ("src/repro_torch/kernels/csrc/admm_iter.cu",
                           "src/repro/kernels/admm_iter/admm_iter.py:82"),
}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str):
    print(f"{'ok  ' if ok else 'FAIL'} {msg}", flush=True)
    if not ok:
        sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(rt, nbytes, nflops, peak="fp32"):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    bw, fp32, bf16 = rt["peaks"]
    tb = nbytes / bw * 1e3
    tf = nflops / (bf16 if peak == "bf16" else fp32) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def record(rt, name, err, k_ms, p_ms, b, lib_ms):
    src, replaces = SOURCES[name]
    rt["records"].append({
        "name": name, "route": "cuda", "source": src,
        "replaces": replaces, "launches": rt["launches"][name],
        "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms})
    print(f"time {name}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"bound {b[0]:.3f} ms ({b[1]}), library "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}, "
          f"err {err:.2e}", flush=True)


def free_device_memory(torch):
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


class Timer:
    """Median of per-call CUDA-event times, after a warm-up call."""

    def __init__(self, torch, reps: int):
        self.torch, self.reps = torch, reps

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def rel_err(torch, got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def gram_err(torch, got, want) -> float:
    """max |dG_ab| / sqrt(G_aa G_bb): Cauchy-Schwarz scale, so a column of
    large entries cannot hide the error of a small one."""
    got, want = got.double(), want.double()
    dg = torch.sqrt(torch.clamp(torch.diagonal(want), min=1e-30))
    return float(((got - want).abs() / (dg[:, None] * dg[None, :])).max())


def phase_kernels(torch, rt):
    from repro_torch.core.prox import make_hinge, make_logistic
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.kernels.admm_iter import ops as iter_ops
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.prox import ops as prox_ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # K1: five kinds, ragged m
    for m in (1000, 262144 + 77):
        dx, lam = 3 * randn(m), randn(m)
        aux = torch.sign(randn(m))
        for kind in KINDS:
            delta = {"logistic": 10.0, "hinge": 0.7, "l1": 0.3,
                     "least_squares": 2.0, "quantile": 1.5}[kind]
            a = None if kind == "l1" else aux
            p = 0.3 if kind == "quantile" else 0.0
            y1, l1 = prox_ops.prox_update(dx, lam, a, kind=kind, delta=delta,
                                          param=p)
            y1b, l1b = prox_ops.prox_update(dx, lam, a, kind=kind,
                                            delta=delta, param=p)
            y2, l2 = prox_ops.prox_update_plain(dx, lam, a, kind=kind,
                                                delta=delta, param=p)
            e = max(rel_err(torch, y1, y2), rel_err(torch, l1, l2))
            check(e <= 4e-6 and torch.equal(y1, y1b) and torch.equal(l1, l1b),
                  f"K1 prox {kind:13s} m={m}: rel err {e:.2e} <= 4e-6, "
                  "bitwise repeat")
    # K1 logistic on the hard grid (tests/test_torch_prox.py): z uniform on
    # [-1000, 1000], z ~ N(0, 9) and the edges 0, +-1e-30, +-30, +-88, with
    # labels -1, 0 and 1; deltas 1e-3 to 1e3 (0 to 10 bisection steps);
    # 0, 3 and 8 clamped Newton steps. Against the plain version (the
    # reference's 40 bisection steps) and the mirror of the kernel's chain,
    # 4e-6 of max(1, max |y|) for each label; element by element within 4
    # float32 rounding bands of the float64 root
    from repro_torch.kernels.prox.ref import (logistic_prox_bracketed,
                                              logistic_root_band)
    zs = torch.cat([2000 * torch.rand(20000, generator=g, device=dev) - 1000,
                    3 * randn(20000),
                    torch.tensor([0.0, 1e-30, -1e-30, 30.0, -30.0, 88.0,
                                  -88.0], device=dev)])
    labels = (-1.0, 0.0, 1.0)
    z = zs.repeat(len(labels))
    a = torch.tensor(labels, device=dev).repeat_interleave(zs.numel())
    zero = torch.zeros_like(z)

    def per_label(got, want):
        return max(rel_err(torch, got[a == lab], want[a == lab])
                   for lab in labels)

    worst = {"plain": 0.0, "mirror": 0.0, "bands": 0.0, "plain bands": 0.0}
    for delta in (1e-3, 0.05, 1.0, 4.0, 10.0, 20.0, 100.0, 1e3):
        root, band = logistic_root_band(z, delta, a)
        for ni in (0, 3, 8):
            y1, l1 = prox_ops.prox_update(z, zero, a, kind="logistic",
                                          delta=delta, newton_iters=ni)
            y1b, l1b = prox_ops.prox_update(z, zero, a, kind="logistic",
                                            delta=delta, newton_iters=ni)
            yp, _ = prox_ops.prox_update_plain(z, zero, a, kind="logistic",
                                               delta=delta, newton_iters=ni)
            ym = logistic_prox_bracketed(z, delta, a, ni)
            e = {"plain": per_label(y1, yp), "mirror": per_label(y1, ym),
                 "bands": float(((y1.double() - root).abs() / band).max()),
                 "plain bands": float(((yp.double() - root).abs()
                                       / band).max())}
            worst = {k: max(v, e[k]) for k, v in worst.items()}
            check(e["plain"] <= 4e-6 and e["mirror"] <= 4e-6
                  and e["bands"] <= 4.0 and torch.equal(y1, y1b)
                  and torch.equal(l1, l1b),
                  f"K1 logistic hard grid delta={delta:g} newton_iters={ni}:"
                  f" vs plain {e['plain']:.2e}, vs mirror {e['mirror']:.2e}"
                  f" <= 4e-6; vs the f64 root {e['bands']:.2f} rounding "
                  f"bands <= 4 (plain {e['plain bands']:.2f}); bitwise "
                  "repeat")
    print("K1 hard grid, worst: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                              worst.items()), flush=True)
    # K2a / K2b: ragged n, f32 and bf16, RHS widths 1, 5, 16 (riding the
    # diagonal tiles) and 70 (RHS tiles of their own, two groups); K2a also
    # on a row-offset view (its base off 16-byte alignment), which must give
    # the bits of an aligned copy
    for (m, n) in ((1000, 33), (1000, 307), (4099, 130)):
        for dt in (torch.float32, torch.bfloat16):
            base = randn(m + 3, n).to(dt)
            D = base[:m]
            G1 = gram_ops.gram(D)
            G1b = gram_ops.gram(D)
            G2 = gram_ops.gram_plain(D)
            e = gram_err(torch, G1, G2)
            check(e <= 1e-5 and torch.equal(G1, G1b)
                  and torch.equal(G1, G1.T),
                  f"K2a gram m={m} n={n} {str(dt)[6:]}: err {e:.2e} <= 1e-5,"
                  " bitwise repeat, exactly symmetric")
            Gv, Gc = gram_ops.gram(base[3:]), gram_ops.gram(base[3:].clone())
            e = gram_err(torch, Gv, gram_ops.gram_plain(base[3:]))
            check(e <= 1e-5 and torch.equal(Gv, Gc),
                  f"K2a gram m={m} n={n} {str(dt)[6:]} row-offset view: err "
                  f"{e:.2e} <= 1e-5, bitwise equal to an aligned copy")
            for r in (0, 5, 16, 70):
                b = randn(m, r) if r else randn(m)
                G1, C1 = gram_ops.gram_and_rhs(D, b)
                _, C1b = gram_ops.gram_and_rhs(D, b)
                G2, C2 = gram_ops.gram_and_rhs_plain(D, b)
                e = max(gram_err(torch, G1, G2), rel_err(torch, C1, C2))
                check(e <= 1e-5 and torch.equal(C1, C1b)
                      and C1.shape == C2.shape,
                      f"K2b gram+rhs m={m} n={n} r={r} {str(dt)[6:]}: "
                      f"err {e:.2e} <= 1e-5, bitwise repeat")
    # K3: five kinds at n = 307 f32, ragged and even n, bf16, both routes
    # (the ring for n <= 512, the wide kernel past it or when pinned), D
    # aligned and as a row-offset view; each call's route from the counters
    from repro_torch.engine import autotune
    k3 = iter_ops.admm_iter_full
    cases = [(1000, 307, torch.float32, k, None) for k in KINDS] + [
        (1000, 33, torch.float32, "logistic", None),
        (999, 128, torch.float32, "logistic", None),
        (1000, 307, torch.bfloat16, "logistic", None),
        (3001, 512, torch.bfloat16, "quantile", None),
        (70001, 307, torch.float32, "hinge", None),
        (3000, 2050, torch.float32, "logistic", None),
        (4099, 307, torch.float32, "logistic", "wide"),
        (4099, 307, torch.bfloat16, "l1", "wide")]
    for m, n, dt, kind, pin in cases:
        base = randn(m + 1, n).to(dt)
        aux = torch.sign(randn(m))
        y, lam, x = randn(m), randn(m), 0.1 * randn(n)
        a = None if kind == "l1" else aux
        p = 0.3 if kind == "quantile" else 0.0
        key = ("iter", m, n, str(dt)[6:])
        if pin:
            autotune.CACHE[key] = autotune._wide_grid(m, n)
        want = iter_ops.route(m, n, dt)
        for view, D in (("", base[:m]), (" row-offset view", base[1:])):
            before = route_counts(k3)
            out1 = k3(D, a, y, lam, x, kind=kind, delta=2.0, param=p)
            out1b = k3(D, a, y, lam, x, kind=kind, delta=2.0, param=p)
            moved = {r: c - before[r] for r, c in route_counts(k3).items()}
            out2 = iter_ops.admm_iter_plain(D, a, y, lam, x, kind=kind,
                                            delta=2.0, param=p)
            e_yl = max(rel_err(torch, out1[0], out2[0]),
                       rel_err(torch, out1[1], out2[1]))
            e_dwv = max(float((u - v).abs().max() / v.abs().max().clamp(
                min=1)) for u, v in zip(out1[2:], out2[2:]))
            same = all(torch.equal(u, v) for u, v in zip(out1, out1b))
            check(e_yl <= 2e-5 and e_dwv <= 2e-5 and same
                  and moved == {r: 2 * (r == want) for r in moved},
                  f"K3 admm_iter [{want}] {kind:13s} m={m} n={n} "
                  f"{str(dt)[6:]}{view}: y/lam err {e_yl:.2e} <= 2e-5, "
                  f"d/w/v err {e_dwv:.2e} <= 2e-5, bitwise repeat")
        if pin:
            del autotune.CACHE[key]
    # small end-to-end parity: cuda backend vs reference backend, fixed
    # iteration count (tests/test_engine.py::_run_parity tolerances)
    D = randn(4, 250, 20)
    lab = torch.sign(randn(4, 250))
    for loss, tau, rho, iters in ((make_logistic(), 0.1, 0.0, 60),
                                  (make_hinge(1.0), 0.5, 1.0, 80)):
        runs = {be: UnwrappedADMM(loss, tau=tau, rho=rho, backend=be).run(
            D, lab, iters=iters) for be in ("reference", "cuda")}
        ref, got = runs["reference"], runs["cuda"]
        nx = float(torch.linalg.norm(got.x - ref.x) / torch.linalg.norm(ref.x))
        no = float(((got.history.objective - ref.history.objective).abs()
                    / ref.history.objective.abs()).max())
        check(nx < 2e-4 and no < 1e-4,
              f"small solve {loss.name}: cuda vs reference x rel {nx:.2e} "
              f"< 2e-4, objective rel {no:.2e} < 1e-4")


def phase_main(torch, rt, rows: int, iters: int):
    from repro_torch.core.prox import make_hinge, make_logistic
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.data.synthetic import star_catalog_problem
    from repro_torch.kernels.admm_iter import ops as iter_ops
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.prox import ops as prox_ops

    t0 = time.perf_counter()
    prob = star_catalog_problem(SEED, 1, rows)
    torch.cuda.synchronize()
    D, lab = prob.D, prob.labels
    m, n = rows, D.shape[-1]
    print(f"data: star catalog {m} x {n} f32 ({D.numel() * 4 / 1e9:.1f} GB) "
          f"in {time.perf_counter() - t0:.1f}s, "
          f"labels +1 share {float((lab > 0).float().mean()):.3f}",
          flush=True)
    check(n == 307 and bool(torch.isfinite(D).all()),
          "data: 307 finite features")

    def summary(res):
        x = res.x
        Dx = D.reshape(m, n) @ x
        a = lab.reshape(m)
        obj = float(torch.sum(torch.logaddexp(-a * Dx,
                                              torch.zeros((), device="cuda"))))
        acc = float(torch.mean((torch.sign(Dx) == a).float()))
        return obj, acc

    logistic = dict(loss=make_logistic(), tau=0.1)
    svm = dict(loss=make_hinge(1.0), tau=0.5, rho=1.0)
    for fn in (prox_ops.prox_update, gram_ops.gram, gram_ops.gram_and_rhs,
               iter_ops.admm_iter_full):
        zero_counts(fn)
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for label, kw, extra in (("f32", logistic, {}),
                             ("bf16", logistic, {"residency": "bf16"}),
                             ("svm", svm, {})):
        solver = UnwrappedADMM(**kw, **extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(D, lab, max_iters=iters)
        torch.cuda.synchronize()
        runs[label] = (res, time.perf_counter() - t0, solver)
    launches = {
        "K1_prox_update": prox_ops.prox_update.launches,
        "K2a_gram": gram_ops.gram.launches,
        "K2b_gram_and_rhs": gram_ops.gram_and_rhs.launches,
        "K3_admm_iter": iter_ops.admm_iter_full.launches,
    }
    peak = torch.cuda.max_memory_allocated() / 1e9
    total_iters = sum(r[0].iters for r in runs.values())
    check(launches["K2a_gram"] == 3,
          f"main path: K2a launched {launches['K2a_gram']} times = 3 Gram "
          "setups")
    check(launches["K3_admm_iter"] == total_iters,
          f"main path: K3 launched {launches['K3_admm_iter']} times = "
          f"{total_iters} iterations")
    k3_routes = route_counts(iter_ops.admm_iter_full)
    check(k3_routes == {"ring": total_iters, "wide": 0},
          f"main path: K3 routes {k3_routes}: all on the ring kernel")
    rt["launches"] = launches

    for label, (res, secs, solver) in runs.items():
        check(bool(torch.isfinite(res.x).all()) and res.x.shape == (n,),
              f"{label}: x finite, shape ({n},)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        L = solver.setup(D)
        torch.cuda.synchronize()
        setup_ms = (time.perf_counter() - t0) * 1e3
        if label == "f32":
            # cond_2(G) = cond_2(L)^2 for the Cholesky factor L of G
            cond = float(torch.linalg.cond(L.double())) ** 2
            print(f"main: Gram condition number {cond:.4g}", flush=True)
        obj, acc = summary(res)
        per_iter = (secs * 1e3 - setup_ms) / max(res.iters, 1)
        if label == "f32":       # phase 9 holds the ranks' x to this one
            rt["local_f32"] = (res.x, res.iters, per_iter)
        print(f"main {label}: {res.iters} iters, objective {obj:.6g}, "
              f"train acc {acc:.4f}, gram setup {setup_ms:.1f} ms, "
              f"{per_iter:.2f} ms/iter, solve {secs:.2f} s", flush=True)
        check(acc > 0.6, f"{label}: train accuracy {acc:.4f} > 0.6")
    print(f"main: peak device memory {peak:.2f} GB", flush=True)

    # x against the reference backend on the card, at equal iteration
    # counts (the two stop where their own residuals cross the tolerance).
    # The f32 reference backend's own error is large at this m: its cuBLAS
    # products sum 16.7M rows in f32. So both are also held against the
    # same reference backend run in float64, the closest to exact this
    # card can do.
    res_c = runs["f32"][0]
    ref_solver = UnwrappedADMM(**logistic, backend="reference")
    res_r = ref_solver.solve(D, lab, max_iters=res_c.iters)
    check(abs(res_r.iters - res_c.iters) <= 3,
          f"stop iteration: cuda {res_c.iters}, reference {res_r.iters} "
          "(within 3)")
    k = res_r.iters
    if k != res_c.iters:
        res_c = UnwrappedADMM(**logistic).solve(D, lab, max_iters=k)
    res_b = runs["bf16"][0]
    if res_b.iters != k:
        res_b = UnwrappedADMM(**logistic, residency="bf16").solve(
            D, lab, max_iters=k)
    x_c, x_r, x_b = res_c.x, res_r.x, res_b.x
    rt["main"] = (D, lab, res_c.x, res_c.y, res_c.lam)
    del runs, res_c, res_r, res_b
    D64 = D.double()
    res_64 = UnwrappedADMM(**logistic, backend="reference").solve(
        D64, lab.double(), max_iters=k)
    del D64
    x64 = res_64.x

    def rel(u, v):
        return float(torch.linalg.norm(u.double() - v.double())
                     / torch.linalg.norm(v.double()))

    e_c, e_r, e_b, e_cr = rel(x_c, x64), rel(x_r, x64), rel(x_b, x64), \
        rel(x_c, x_r)
    print(f"x after {k} iters: f64 reference stopped at {res_64.iters}; "
          f"f32 reference backend vs f64 {e_r:.2e}", flush=True)
    check(res_64.iters == k and e_c <= 1e-4,
          f"f32 cuda backend x vs f64 reference: rel {e_c:.2e} <= 1e-4")
    # the f32 reference's own distance from f64 (printed above) bounds how
    # close the two f32 backends can be; 1e-3 leaves it a factor of ~2
    check(e_cr <= 1e-3, f"f32 cuda backend x vs f32 reference backend: "
          f"rel {e_cr:.2e} <= 1e-3")
    # bf16 residency iterates on a rounded copy of D (relative error up to
    # 2^-9 per entry): the JAX suite's bf16 bound
    check(e_b <= 5e-3,
          f"bf16 residency x vs f64 reference: rel {e_b:.2e} <= 5e-3")


def phase_timing(torch, rt, reps: int):
    from repro_torch.kernels.admm_iter import ops as iter_ops
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.prox import ops as prox_ops
    from repro_torch.kernels.prox.ref import logistic_prox_bracketed

    D3, lab, x, y, lam = rt["main"]
    m, n = D3.shape[1], D3.shape[2]
    D = D3.reshape(m, n)
    a = lab.reshape(m)
    x = x.float()
    y, lam = y.reshape(m), lam.reshape(m)
    timer = Timer(torch, reps)
    delta = 1.0 / 0.1

    # K1 at the main path's m: Dx of the solution, its y/lam and labels
    Dx = D @ x
    k1 = lambda: prox_ops.prox_update(Dx, lam, a, kind="logistic",
                                      delta=delta)
    p1 = lambda: prox_ops.prox_update_plain(Dx, lam, a, kind="logistic",
                                            delta=delta)
    (yk, lk), (yp, lp) = k1(), p1()
    ym = logistic_prox_bracketed(Dx + lam, delta, a)
    err = max(float((yk - yp).abs().max()), float((lk - lp).abs().max()))
    e_m = rel_err(torch, yk, ym)
    check(max(rel_err(torch, yk, yp), rel_err(torch, lk, lp)) <= 4e-6
          and e_m <= 4e-6,
          f"K1 at m={m}: err {err:.2e}; vs the mirror of its chain "
          f"{e_m:.2e} <= 4e-6")
    del yk, lk, yp, lp, ym
    record(rt, "K1_prox_update", err, timer(k1), timer(p1),
           bound(rt, 5 * m * 4, m * PROX_FLOPS["logistic"]), None)
    # K1's grid: blocks of 256 threads per SM in the grid-stride launch
    default = prox_ops.BLOCKS_PER_SM
    probe = {}
    try:
        for bps in (4, 8, 16, 32, 64, 128, 512):
            prox_ops.BLOCKS_PER_SM = bps
            probe[bps] = timer(k1)
    finally:
        prox_ops.BLOCKS_PER_SM = default
    print("K1 grid probe (blocks per SM: ms): " + ", ".join(
        f"{b}: {t:.4f}" for b, t in probe.items()) + f"; default {default}",
        flush=True)

    # K2a at the main path's D
    G1, G2 = gram_ops.gram(D), gram_ops.gram_plain(D)
    e = gram_err(torch, G1, G2)
    check(e <= 1e-4 and torch.equal(G1, gram_ops.gram(D)),
          f"K2a at {m}x{n}: err {e:.2e} <= 1e-4, bitwise repeat")
    k2a_ms = timer(lambda: gram_ops.gram(D))
    lib_ms = timer(lambda: D.T @ D)
    record(rt, "K2a_gram", float((G1 - G2).abs().max()), k2a_ms,
           timer(lambda: gram_ops.gram_plain(D)),
           bound(rt, m * n * 4 + n * n * 4, m * n * n), lib_ms)
    nt = -(-n // 64)
    print(f"K2a: {m * n * n / k2a_ms / 1e9:.1f} TFLOP/s of m n^2, "
          f"{m * nt * (nt + 1) * 4096 / k2a_ms / 1e9:.1f} TFLOP/s of the "
          f"{nt * (nt + 1) // 2} upper 64x64 tiles; D.T @ D {lib_ms:.3f} ms",
          flush=True)
    check(k2a_ms < lib_ms, f"K2a {k2a_ms:.3f} ms < D.T @ D {lib_ms:.3f} ms")
    # the Gram's own accuracy: K2a, its plain version and the library call
    # against a float64 Gram of the same D (Cauchy-Schwarz scale)
    G64, _ = f64_stats(torch, D, a)
    errs = {name: gram_err(torch, G, G64) for name, G in (
        ("K2a", G1), ("plain", G2), ("library D.T @ D", D.T @ D))}
    print("gram vs f64: " + ", ".join(f"{k} {v:.2e}" for k, v in
                                      errs.items()), flush=True)
    check(errs["K2a"] <= 1e-5, f"K2a vs f64 Gram: err {errs['K2a']:.2e} "
          "<= 1e-5")
    del G1, G2

    # K2b at the main path's D with the labels as the RHS; the library
    # yardstick is one product D^T [D | a], which holds [G | c]
    (G1, C1), (G2, C2) = gram_ops.gram_and_rhs(D, a), \
        gram_ops.gram_and_rhs_plain(D, a)
    e = max(gram_err(torch, G1, G2), rel_err(torch, C1, C2))
    G1b, C1b = gram_ops.gram_and_rhs(D, a)
    check(e <= 1e-4 and torch.equal(G1, G1b) and torch.equal(C1, C1b),
          f"K2b at {m}x{n}: err {e:.2e} <= 1e-4, bitwise repeat")
    e64 = gram_err(torch, G1, G64)
    check(e64 <= 1e-5, f"K2b vs f64 Gram: err {e64:.2e} <= 1e-5")
    err = max(float((G1 - G2).abs().max()), float((C1 - C2).abs().max()))
    del G1, G2, G1b, C1b, G64
    k2b_ms = timer(lambda: gram_ops.gram_and_rhs(D, a))
    DB = torch.cat([D, a[:, None]], 1)   # 20.6 GB, freed after the timer
    lib_ms = timer(lambda: D.T @ DB)
    del DB
    free_device_memory(torch)
    record(rt, "K2b_gram_and_rhs", err, k2b_ms,
           timer(lambda: gram_ops.gram_and_rhs_plain(D, a)),
           bound(rt, m * n * 4 + m * 4 + n * n * 4 + n * 4,
                 m * n * n + 2 * m * n), lib_ms)
    print(f"K2b: {k2b_ms:.3f} ms against K2a's {k2a_ms:.3f} ms "
          f"({k2b_ms / k2a_ms:.3f}x); D.T @ [D | a] {lib_ms:.3f} ms",
          flush=True)
    check(k2b_ms < lib_ms,
          f"K2b {k2b_ms:.3f} ms < D.T @ [D | a] {lib_ms:.3f} ms")

    # K3 at the main path's D, f32, from the solution's iterates: the ring
    # route (the main path's) in the record, the wide route pinned to the
    # same shape beside it, then both on the bf16 copy (printed)
    from repro_torch.engine import autotune
    k3 = lambda DD: (lambda: iter_ops.admm_iter_full(
        DD, a, y, lam, x, kind="logistic", delta=delta))
    p3 = lambda: iter_ops.admm_iter_plain(D, a, y, lam, x, kind="logistic",
                                          delta=delta)
    check(iter_ops.route(m, n, D.dtype) == "ring",
          f"K3 at {m}x{n} f32 routes to the ring kernel")
    o1, o2 = k3(D)(), p3()
    e_yl = max(rel_err(torch, o1[0], o2[0]), rel_err(torch, o1[1], o2[1]))
    e_dwv = max(float((u - v).abs().max() / v.abs().max().clamp(min=1))
                for u, v in zip(o1[2:], o2[2:]))
    same = all(torch.equal(u, v) for u, v in zip(o1, k3(D)()))
    check(e_yl <= 4e-6 and e_dwv <= 1e-4 and same,
          f"K3 at {m}x{n}: y/lam err {e_yl:.2e} <= 4e-6, d/w/v err "
          f"{e_dwv:.2e} <= 1e-4, bitwise repeat")
    err = max(float((u - v).abs().max()) for u, v in zip(o1, o2))
    del o1, o2
    Db = D.to(torch.bfloat16)
    nflops = m * (8 * n + PROX_FLOPS["logistic"])
    times = {}
    for label, DD in (("f32", D), ("bf16", Db)):
        nbytes = m * n * DD.element_size() + 5 * m * 4 + 4 * n * 4
        tb = bound(rt, nbytes, nflops)
        for route in ("ring", "wide"):
            key = ("iter", m, n, str(DD.dtype)[6:])
            if route == "wide":
                autotune.CACHE[key] = autotune._wide_grid(m, n)
            try:
                if label == "bf16" or route == "wide":
                    ob = k3(DD)()
                    pb = iter_ops.admm_iter_plain(DD, a, y, lam, x,
                                                  kind="logistic",
                                                  delta=delta)
                    e = max(rel_err(torch, ob[0], pb[0]),
                            rel_err(torch, ob[1], pb[1]))
                    check(e <= 4e-6, f"K3 {route} {label} at {m}x{n}: "
                          f"y/lam err {e:.2e} <= 4e-6")
                    del ob, pb
                times[label, route] = timer(k3(DD))
            finally:
                if route == "wide":
                    del autotune.CACHE[key]
            t = times[label, route]
            print(f"time K3_admm_iter [{route}] {label} D: kernel {t:.3f} "
                  f"ms, {nbytes / t / 1e6:.0f} GB/s, bound {tb[0]:.3f} ms "
                  f"({tb[1]})", flush=True)
        # the hinge prox (a few operations) beside the logistic one: the
        # logistic prox's share of K3, measured
        hinge = lambda: iter_ops.admm_iter_full(DD, a, y, lam, x,
                                                kind="hinge", delta=2.0)
        times[label, "hinge"] = timer(hinge)
        t = times[label, "hinge"]
        print(f"time K3_admm_iter [ring] {label} D, hinge prox: kernel "
              f"{t:.3f} ms, {nbytes / t / 1e6:.0f} GB/s; logistic - hinge "
              f"{times[label, 'ring'] - t:.3f} ms", flush=True)
        ring_grid_sweep(torch, autotune, iter_ops, DD, k3(DD), reps)
    check(times["f32", "ring"] < times["f32", "wide"],
          f"K3 ring {times['f32', 'ring']:.3f} ms < wide "
          f"{times['f32', 'wide']:.3f} ms at {m}x{n} f32")
    record(rt, "K3_admm_iter", err, times["f32", "ring"], timer(p3),
           bound(rt, m * n * 4 + 5 * m * 4 + 4 * n * 4, nflops), None)
    del Db


def ring_grid_sweep(torch, autotune, iter_ops, D, fn, reps):
    """K3's ring route on D at every grid it takes
    (``autotune.ring_grids``), timed in two passes (the second in reverse
    order); prints every grid's two times, fastest first, and the
    autotuned grid's place. Timings only: the grid a user gets is
    autotune.iter_grid's."""
    m, n = D.shape
    key = ("iter", m, n, str(D.dtype)[6:])
    tuned = tuple(autotune.iter_grid(m, n, D.dtype))
    timer = Timer(torch, reps)
    grids = autotune.ring_grids(m, n, D.element_size())
    res = {g: [] for g in grids}
    try:
        for order in (grids, grids[::-1]):
            for grid in order:
                autotune.CACHE[key] = grid
                res[grid].append(timer(fn))
    finally:
        autotune.CACHE[key] = tuned
    best = sorted(res, key=lambda g: min(res[g]))
    place = best.index(tuned) + 1 if tuned in res else None
    print(f"K3 ring grid sweep {str(D.dtype)[6:]}, {len(res)} grids "
          "(rows, stages, warps: ms, two passes), fastest first: "
          + ", ".join(f"({g[1]}, {g[3]}, {g[4]}): {res[g][0]:.3f} "
                      f"{res[g][1]:.3f}" for g in best)
          + f"; autotuned ({tuned[1]}, {tuned[3]}, {tuned[4]}) place "
          f"{place}", flush=True)


# The paper's lasso (section 10.1 / Fig. 1c) at its per-node width: the JAX
# CLI's documented 50,000 x 200 per node, 320 nodes, heterogeneous
# phase 9: (world, compress flags) of each group of ranks; all on one card
SHARD_RUNS = ((1, (False,)), (2, (False, True)), (4, (False,)))
SHARD_TIMEOUT = 300.0        # seconds per group of ranks
REDUCE_REPS = 50             # timed reductions per rank


def shard_rank(D, lab, flags, iters):
    """One rank of phase 9, inside its group (``compat.spawn``): a short
    warm-up solve (the first collective, the kernels' first launches),
    then for each compress flag the logistic solve under the shared driver
    on this rank's rows of the shared D (``shard_solve``)."""
    import torch

    from repro_torch.core.prox import make_logistic
    from repro_torch.engine import IterationEngine
    from repro_torch.exec import ShardMapExecutor, solve_with_executor
    from repro_torch.sharding.compat import current_group

    group = current_group()
    dev = torch.device("cuda", torch.cuda.current_device())
    eng = IterationEngine(make_logistic(), tau=0.1, device=str(dev))
    for compress in sorted(set(flags)):
        ex = ShardMapExecutor(eng, D, lab, group=group, compress=compress)
        solve_with_executor(ex, loss=eng.loss, tau=0.1, max_iters=2)
        del ex
    return [shard_solve(D, lab, eng, group, dev, compress, iters)
            for compress in flags]


def loop_clock(ex, dev):
    """Host timestamps, each after a synchronize, at the start and the end
    of the shared driver's iteration loop on executor ``ex``: ``init``
    returns just before the first iteration, ``finish`` is called just
    after the last. Returns the dict they are written to."""
    import torch

    marks = {}
    init, finish = ex.init, ex.finish

    def timed_init(x0):
        d = init(x0)
        torch.cuda.synchronize(dev)
        marks["start"] = time.perf_counter()
        return d

    def timed_finish(iters, converged):
        torch.cuda.synchronize(dev)
        marks["stop"] = time.perf_counter()
        finish(iters, converged)

    ex.init, ex.finish = timed_init, timed_finish
    return marks


def clocked_solve(ex, eng, dev, iters, sync=lambda: None, **solve_kw):
    """``solve_with_executor`` on ``ex`` under ``loop_clock``: (result,
    setup s from the call to the loop, iteration ms per iteration, final s
    from the loop to the return), the same yardstick on every executor.
    ``eng`` is anything with the solve's ``loss``; ``solve_kw`` go to the
    driver."""
    import torch

    from repro_torch.exec import solve_with_executor

    marks = loop_clock(ex, dev)
    sync()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = solve_with_executor(ex, loss=eng.loss, tau=0.1, max_iters=iters,
                              **solve_kw)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    it_ms = (marks["stop"] - marks["start"]) * 1e3 / max(res.iters, 1)
    return res, marks["start"] - t0, it_ms, t1 - marks["stop"]


def shard_solve(D, lab, eng, group, dev, compress, iters):
    """One timed solve of ``shard_rank``: the rank's K2a / K3 counts (set
    to 0 just before the solve, read just after), its peak device memory
    above what it held before, its setup, iterations and final gather from
    ``clocked_solve`` (no part run twice), and one reduction timed apart
    (between a barrier and a synchronize)."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.engine.streaming import SweepResult
    from repro_torch.exec import ShardMapExecutor
    from repro_torch.kernels.admm_iter import ops as iter_ops
    from repro_torch.kernels.gram import ops as gram_ops

    def timed(fn):
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, out

    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ex = ShardMapExecutor(eng, D, lab, group=group, compress=compress)
    for fn in (gram_ops.gram, iter_ops.admm_iter_full):
        zero_counts(fn)
    res, setup_s, it_ms, final_s = clocked_solve(ex, eng, dev, iters,
                                                 sync=dist.barrier)
    launches = {"K2a": gram_ops.gram.launches,
                "K3": iter_ops.admm_iter_full.launches,
                "K3_ring": iter_ops.admm_iter_full.launches_ring}
    peak = torch.cuda.max_memory_allocated(dev) - base
    z = torch.zeros(ex.n, device=dev)
    s = torch.zeros((), device=dev)
    sw = SweepResult(z, z, z, s, s, s, s)
    comm_s, _ = timed(lambda: [ex.reduce(sw) for _ in range(REDUCE_REPS)])
    return {"x": res.x, "iters": res.iters, "it_ms": it_ms,
            "setup_s": setup_s, "final_s": final_s,
            "comm_ms": comm_s * 1e3 / REDUCE_REPS, "launches": launches,
            "peak": peak, "rows": ex._D.shape[0], "extra": ex.extra_record()}


def ef_reference(torch, D, a, world: int, iters: int):
    """x after ``iters`` iterations of the compressed solve over ``world``
    ranks, computed in this process as a plain loop: K2a and K3 on each
    rank's rows, each rank's d through ``ef_compress`` with the residual
    that rank carries, the dequantized codes summed in rank order. It
    shares the kernels and ``ef_compress`` with the ranks, and not the
    executor, the driver, the collectives or their staging through the
    host. The kernels have fixed reduction orders, so it should give the
    ranks' bits: under int8 error feedback a last-bit difference flips a
    code and the two solves part by the compression's own noise (~1e-2 on
    the star catalog), so no plain body could hold them closer than that."""
    from repro_torch.cluster.compress import dequantize_int8, ef_compress
    from repro_torch.core.gram import gram_factor, gram_solve
    from repro_torch.core.prox import make_logistic
    from repro_torch.engine import IterationEngine

    eng = IterationEngine(make_logistic(), tau=0.1, device=str(D.device))
    rows, n = D.shape[0] // world, D.shape[1]
    shards = [(D[r * rows:(r + 1) * rows], a[r * rows:(r + 1) * rows])
              for r in range(world)]
    G = sum(eng.gram(S)[0] for S, _ in shards)
    L = gram_factor(G, ridge=0.0)
    zeros = lambda k: torch.zeros((k,), dtype=torch.float32, device=D.device)
    ys, lams, errs = ([zeros(rows) for _ in shards],
                      [zeros(rows) for _ in shards], [zeros(n) for _ in shards])
    d = zeros(n)
    x = d
    for _ in range(iters):
        x = gram_solve(L, d)
        parts = []
        for r, (S, A) in enumerate(shards):
            st = eng.iterate(S, A, ys[r], lams[r], x, want_dual=True)
            ys[r], lams[r] = st.y, st.lam
            q, scale, errs[r] = ef_compress(st.d, errs[r])
            parts.append(dequantize_int8(q, scale, n))
        d = parts[0].clone()
        for p in parts[1:]:
            d += p
    return x


def phase_shard_map(torch, rt, reps: int):
    """Phase 9: the shard_map path on phase 4's star catalog, shared with
    the ranks by CUDA IPC (one copy of D on the card; each rank a view of
    its rows): world 1 on NCCL, worlds 2 and 4 on gloo (ranks sharing the
    card), world 2 also compressed; then K3 at the world-4 shard's shape
    against its plain version."""
    import numpy as np

    from repro_torch.kernels.admm_iter import ops as iter_ops
    from repro_torch.sharding import compat

    D3, lab, _, y, lam = rt["main"]
    x_loc, it_loc, ms_loc = rt["local_f32"]
    m, n = D3.shape[1], D3.shape[2]
    D, a = D3.reshape(m, n), lab.reshape(m)
    xl = x_loc.double()

    def gap(x):
        x = torch.as_tensor(x, device=xl.device).double()
        return float((x - xl).abs().max() / max(1.0, float(xl.abs().max())))

    def objective(x):
        """sum softplus(-a Dx) in float64 over row blocks."""
        x = torch.as_tensor(x, device=D.device).double()
        return sum(float(torch.nn.functional.softplus(
            -a[s:s + (1 << 20)].double() * (D[s:s + (1 << 20)].double() @ x)
        ).sum()) for s in range(0, m, 1 << 20))

    obj_loc = objective(x_loc)

    # the local solve again, on the ranks' yardstick (``clocked_solve``)
    from repro_torch.core.prox import make_logistic
    from repro_torch.engine import IterationEngine
    from repro_torch.exec import LocalExecutor
    eng = IterationEngine(make_logistic(), tau=0.1, device="cuda")
    res, setup_s, it_ms_loc, _ = clocked_solve(
        LocalExecutor(eng, D3, lab), eng, torch.device("cuda"), ITERS)
    check(torch.equal(res.x, x_loc) and res.iters == it_loc,
          "shard_map: the local solve repeats phase 4's x bit for bit")
    print(f"shard_map: local solve {it_loc} iterations, "
          f"{it_ms_loc:.2f} ms/iter, setup {setup_s * 1e3:.1f} ms (the "
          f"ranks' yardstick; phase 4's: {ms_loc:.2f} ms/iter)", flush=True)
    del res
    for world, flags in SHARD_RUNS:
        backend = compat.layout_backend("cuda", world)
        check(world > torch.cuda.device_count() or backend == "nccl",
              f"shard_map world {world}: each rank has its own card -> "
              f"{backend}")
        t0 = time.perf_counter()
        ranks = compat.spawn(shard_rank, world, backend,
                             args=(D, a, flags, ITERS), device="cuda",
                             timeout=SHARD_TIMEOUT)
        wall = time.perf_counter() - t0
        print(f"shard_map world {world}: {world} ranks on {backend}, "
              f"spawned, solved and joined in {wall:.1f} s", flush=True)
        for i, compress in enumerate(flags):
            rs = [r[i] for r in ranks]
            r0 = rs[0]
            label = f"world {world}{' compressed' if compress else ''}"
            same = all(np.array_equal(r["x"].view(np.uint32),
                                      r0["x"].view(np.uint32))
                       and r["iters"] == r0["iters"] for r in rs)
            check(same, f"{label}: x and iterations bitwise equal on the "
                  f"{world} ranks ({r0['iters']} iterations)")
            k = r0["iters"]
            counts = [r["launches"] for r in rs]
            check(all(c == {"K2a": 1, "K3": k, "K3_ring": k}
                      for c in counts),
                  f"{label}: per rank K2a 1, K3 {k} (all ring) launches: "
                  f"{counts}")
            check(r0["extra"] == {"shards": world, "group_backend": backend},
                  f"{label}: extra_record {r0['extra']}")
            e = gap(r0["x"])
            if compress:
                # an int8 code's step is 1/127 of its group's largest
                # entry, and the star catalog's d spans ~60 to ~50,000, so
                # its small entries fall below a step: the compressed
                # solve's optimum is not the plain one's (the JAX
                # package's own lands ~9e-3 from its plain one in
                # objective, tests/test_torch_distributed.py). So x is
                # held against the same compressed solve as a loop in this
                # process (``ef_reference``, the same iteration count) at
                # the uncompressed parity limit, 1e-5: a residual not
                # carried or a code from the wrong rank moves x ~1e-2.
                t1 = time.perf_counter()
                x_ef = ef_reference(torch, D, a, world, k)
                xr = torch.as_tensor(r0["x"], device=x_ef.device)
                e_ef = float((xr.double() - x_ef.double()).abs().max()
                             / max(1.0, float(x_ef.abs().max())))
                check(e_ef <= 1e-5, f"{label}: x vs the in-process EF loop "
                      f"at {k} iterations, rel sup-norm {e_ef:.2e} <= 1e-05,"
                      f" bit-identical {torch.equal(xr, x_ef)} (loop in "
                      f"{time.perf_counter() - t1:.1f} s)")
                e_obj = abs(objective(r0["x"]) - obj_loc) / abs(obj_loc)
                check(e_obj <= 2e-2, f"{label}: objective vs the local "
                      f"solve's, rel {e_obj:.2e} <= 2e-2 (x: rel sup-norm "
                      f"{e:.2e}; {k} vs {it_loc} iterations)")
            else:
                check(e <= 1e-5, f"{label}: x vs the local x, rel sup-norm "
                      f"{e:.2e} <= 1e-05 ({k} vs {it_loc} iterations)")
            if world == 1:
                bit = torch.equal(torch.as_tensor(r0["x"]),
                                  x_loc.cpu()) and k == it_loc
                print(f"shard_map world 1 on NCCL bit-identical to the "
                      f"local solve: {bit}", flush=True)
            it_ms = max(r["it_ms"] for r in rs)
            print(f"shard_map {label}: {k} iterations, "
                  f"{it_ms:.2f} ms/iter (local {it_ms_loc:.2f}, same "
                  f"clock); reduction {r0['comm_ms']:.3f} ms/iter "
                  f"apart from K3; setup {max(r['setup_s'] for r in rs) * 1e3:.1f}"
                  f" ms; final gather {max(r['final_s'] for r in rs) * 1e3:.1f}"
                  f" ms; peak device memory per rank "
                  f"{[round(r['peak'] / 2**20, 1) for r in rs]} MiB; rows "
                  f"per rank {r0['rows']}", flush=True)
        if world == 4:
            rt["launches"]["K3_admm_iter_shard"] = sum(
                r[0]["launches"]["K3"] for r in ranks)

    # K3 at the world-4 shard's shape (the first rank's rows), from the
    # local solution's iterates; the world-2 shard timed beside it
    timer = Timer(torch, reps)
    delta = 1.0 / 0.1
    x = x_loc.float()
    for rows in (m // 2, m // 4):
        Ds, As = D[:rows], a[:rows]
        ys = y.reshape(-1)[:rows].contiguous()
        ls = lam.reshape(-1)[:rows].contiguous()
        k3 = lambda: iter_ops.admm_iter_full(Ds, As, ys, ls, x,
                                             kind="logistic", delta=delta)
        check(iter_ops.route(rows, n, D.dtype) == "ring",
              f"K3 at the shard {rows}x{n} routes to the ring kernel")
        if rows != m // 4:
            print(f"time K3 at the world-2 shard {rows}x{n}: "
                  f"{timer(k3):.3f} ms", flush=True)
            continue
        p3 = lambda: iter_ops.admm_iter_plain(Ds, As, ys, ls, x,
                                              kind="logistic", delta=delta)
        o1, o2 = k3(), p3()
        e_yl = max(rel_err(torch, o1[0], o2[0]),
                   rel_err(torch, o1[1], o2[1]))
        e_dwv = max(float((u - v).abs().max() / v.abs().max().clamp(min=1))
                    for u, v in zip(o1[2:], o2[2:]))
        same = all(torch.equal(u, v) for u, v in zip(o1, k3()))
        check(e_yl <= 4e-6 and e_dwv <= 1e-4 and same,
              f"K3 at the shard {rows}x{n}: y/lam err {e_yl:.2e} <= 4e-6, "
              f"d/w/v err {e_dwv:.2e} <= 1e-4, bitwise repeat")
        err = max(float((u - v).abs().max()) for u, v in zip(o1, o2))
        del o1, o2
        record(rt, "K3_admm_iter_shard", err, timer(k3), timer(p3),
               bound(rt, rows * n * 4 + 5 * rows * 4 + 4 * n * 4,
                     rows * (8 * n + PROX_FLOPS["logistic"])), None)


LASSO = dict(N=320, m_per_node=50_000, n=200)
LASSO_ITERS = 500            # FASTA iterations of the gram-path fits
CONSENSUS_ITERS = 400        # outer iterations of the consensus baseline
SMALL = dict(N=4, m_per_node=250, n=20)   # the JAX tests' size
SMALL_ITERS = 60             # registry keys on the card (SVM consensus: 40)
GRAM_KEYS = (("lasso", "transpose"), ("lasso", "fasta"),
             ("ridge", "transpose"), ("elastic_net", "transpose"),
             ("nnls", "transpose"))


def f64_stats(torch, D2, b2, block=1 << 20):
    """(G, c) in float64 over row blocks."""
    n = D2.shape[1]
    G = torch.zeros((n, n), dtype=torch.float64, device=D2.device)
    c = torch.zeros((n,), dtype=torch.float64, device=D2.device)
    for s in range(0, D2.shape[0], block):
        blk = D2[s:s + block].double()
        G += blk.T @ blk
        c += blk.T @ b2[s:s + block].double()
    return G, c


def lasso_obj(torch, G, c, bb, x, mu):
    """0.5 ||Dx - b||^2 + mu |x|_1 from float64 (G, c, ||b||^2)."""
    x = x.double()
    return float(0.5 * x @ G @ x - c @ x + 0.5 * bb
                 + mu * torch.sum(torch.abs(x)))


def phase_problems(torch, rt, reps: int):
    """The problem surface: the paper's lasso through ``fit()`` at full
    size (K2b, then FASTA on the 200 x 200 Gram) with the other gram-path
    problems and the consensus baseline; every registry key and every
    executor problem small, card against CPU; K2b timed at the lasso's
    shape."""
    from repro_torch.core.fasta import transpose_reduction_lasso
    from repro_torch.core.fit import fit
    from repro_torch.data.synthetic import lasso_problem
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.service import registry

    t0 = time.perf_counter()
    prob = lasso_problem(SEED, LASSO["N"], LASSO["m_per_node"], LASSO["n"],
                         heterogeneity=1.0)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    D, b, mu = prob.D, prob.b, float(prob.mu)
    N, mi, n = D.shape
    m = N * mi
    D2, b2 = D.reshape(m, n), b.reshape(m)
    print(f"lasso: {N} nodes x {mi} rows x {n} features f32 "
          f"({D.numel() * 4 / 1e9:.1f} GB), heterogeneous, mu {mu:.6g}; "
          f"data {data_s:.2f} s", flush=True)
    check(bool(torch.isfinite(D).all()) and bool(torch.isfinite(b).all()),
          "lasso data finite")

    # the gram-path fits, K2b's count set to 0 just before; the K2b call
    # inside each fit timed by CUDA events around the registry's
    # gram_stats
    real_stats = registry.gram_stats
    k2b_ms = []

    def timed_stats(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_stats(*a, **k)
        e1.record()
        e1.synchronize()
        k2b_ms.append(e0.elapsed_time(e1))
        return out

    extra = {"lasso": dict(mu=mu), "ridge": {},
             "elastic_net": dict(mu=mu, l2=0.1 * mu), "nnls": {}}
    fits = {}
    registry.gram_stats = timed_stats
    zero_counts(gram_ops.gram_and_rhs)
    for problem, method in GRAM_KEYS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fit(problem, D, b, method=method, iters=LASSO_ITERS,
                **extra[problem])
        torch.cuda.synchronize()
        fits[problem, method] = (r, time.perf_counter() - t0)
    launches = gram_ops.gram_and_rhs.launches
    registry.gram_stats = real_stats
    check(launches == len(GRAM_KEYS),
          f"lasso path: K2b launched {launches} times = {len(GRAM_KEYS)} "
          "gram-path fits")
    rt["launches"]["K2b_gram_and_rhs_lasso"] = launches
    for (problem, method), ms in zip(GRAM_KEYS, k2b_ms):
        r, secs = fits[problem, method]
        print(f"fit {problem}/{method}: {r.iters} iters, {secs:.3f} s = "
              f"K2b {ms:.2f} ms + FASTA/solve {secs - ms / 1e3:.3f} s",
              flush=True)

    # the float64 (G, c) of the same D, and K2b's own against it
    G64, c64 = f64_stats(torch, D2, b2)
    bb = float(torch.sum(b2.double() ** 2))
    G1, c1 = gram_ops.gram_and_rhs(D2, b2)
    dg = torch.sqrt(torch.diagonal(G64))
    e_g = gram_err(torch, G1, G64)
    e_c = float(((c1.double() - c64).abs() / (dg * math.sqrt(bb))).max())
    check(e_g <= 1e-5 and e_c <= 1e-5,
          f"K2b (G, c) at {m}x{n} vs f64: G err {e_g:.2e}, c err {e_c:.2e} "
          "<= 1e-5")
    del G1, c1

    # each solution against the same solve in float64 on (G64, c64)
    x_l = fits["lasso", "transpose"][0].x
    check(torch.equal(x_l, fits["lasso", "fasta"][0].x),
          "lasso: the fasta alias gives the transpose x bit for bit")
    ref = transpose_reduction_lasso(G64, c64, mu, iters=LASSO_ITERS)
    dx = (x_l.double() - ref.x).abs()
    e = float((dx - 1e-3 * ref.x.abs()).max())
    corr = G64 @ x_l.double() - c64
    viol = max(float(corr.abs().max()) - mu, 0.0)
    sup = x_l.abs() > 1e-7
    sup_err = float((corr[sup] + mu * torch.sign(x_l.double()[sup]))
                    .abs().max())
    check(e <= 1e-5, f"lasso x vs f64 FASTA: max |dx| "
          f"{float(dx.max()):.2e}, max(|dx| - 1e-3 |x|) {e:.2e} <= 1e-5 "
          f"(support {int(sup.sum())}, f64 "
          f"{int((ref.x.abs() > 1e-7).sum())})")
    check(viol <= 1e-3 * mu, f"lasso KKT violation {viol:.3e} <= 1e-3 mu "
          f"({1e-3 * mu:.3e}); support err {sup_err:.3e}")
    x_r = fits["ridge", "transpose"][0].x.double()
    want = torch.linalg.solve(G64 + torch.eye(n, dtype=torch.float64,
                                              device=G64.device), c64)
    e = float(torch.linalg.norm(x_r - want) / torch.linalg.norm(want))
    check(e <= 1e-4, f"ridge x vs f64 closed form: rel {e:.2e} <= 1e-4")
    x_e = fits["elastic_net", "transpose"][0].x
    ref_e = transpose_reduction_lasso(G64, c64, mu, iters=LASSO_ITERS,
                                      l2=0.1 * mu)
    e = float(((x_e.double() - ref_e.x).abs()
               - 1e-3 * ref_e.x.abs()).max())
    check(e <= 1e-5, f"elastic_net x vs f64 FASTA: max(|dx| - 1e-3 |x|) "
          f"{e:.2e} <= 1e-5")
    x_n = fits["nnls", "transpose"][0].x.double()
    g = G64 @ x_n - c64
    pg = torch.where(x_n > 0, g, torch.clamp(g, max=0.0))
    v = float(pg.abs().max())
    check(bool((x_n >= 0).all()) and v <= 1e-3 * float(c64.abs().max()),
          f"nnls x >= 0, f64 projected gradient {v:.3e} <= 1e-3 max |c| "
          f"({1e-3 * float(c64.abs().max()):.3e})")

    # the paper's comparison: time to model, transpose against consensus
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = fit("lasso", D, b, mu=mu, method="consensus",
             iters=CONSENSUS_ITERS)
    torch.cuda.synchronize()
    cons_s = time.perf_counter() - t0
    o_t = lasso_obj(torch, G64, c64, bb, x_l, mu)
    o_c = lasso_obj(torch, G64, c64, bb, rc.x, mu)
    check(math.isfinite(o_c) and bool(torch.isfinite(
        rc.objective_history).all()), "consensus lasso objective finite")
    r_t, trans_s = fits["lasso", "transpose"]
    print(f"time to model: transpose {trans_s:.3f} s ({r_t.iters} FASTA "
          f"iters, K2b {k2b_ms[0]:.2f} ms), "
          f"consensus {cons_s:.3f} s ({CONSENSUS_ITERS} iters, Boyd's "
          f"rule first held at {rc.iters}); objective gap (consensus - "
          f"transpose) / "
          f"transpose {(o_c - o_t) / o_t:.3e}", flush=True)
    # the same work warm (the first fit paid the libraries' one-time set
    # up), and the consensus run cut to the iteration where Boyd's rule
    # first held: time to model by each method's own stopping rule
    r_w, warm_s = fits["lasso", "fasta"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc2 = fit("lasso", D, b, mu=mu, method="consensus", iters=rc.iters)
    torch.cuda.synchronize()
    cons_stop_s = time.perf_counter() - t0
    print(f"time to model, warm: transpose {warm_s:.3f} s (K2b "
          f"{k2b_ms[1]:.2f} ms + FASTA {warm_s - k2b_ms[1] / 1e3:.3f} s, "
          f"{r_w.iters} iters); consensus to Boyd's rule {cons_stop_s:.3f} "
          f"s ({rc2.iters} iters), {CONSENSUS_ITERS} iters "
          f"{cons_s:.3f} s; consensus / transpose "
          f"{cons_stop_s / warm_s:.1f}x", flush=True)
    rt["lasso"] = (D2, b2)
    rt["lasso64"] = (G64, c64)
    del fits, rc, rc2, ref, ref_e, G64, c64

    phase_registry_small(torch)
    phase_lasso_timing(torch, rt, reps)
    phase_service(torch, rt, D, b, mu)
    del rt["lasso"], rt["lasso64"], D, b, D2, b2, prob
    print(f"lasso: freed, {free_device_memory(torch):.2f} GB still "
          "allocated", flush=True)


def phase_registry_small(torch):
    """Every registry key and every executor problem at the JAX tests'
    size on the card, against the same call on the CPU (plain versions):
    x rel 2e-4 and objective history rel 1e-4 (tests/test_engine.py:110).
    The consensus SVM's greedy CD order follows
    rounding (ROADMAP section 3): its final objective is held to 2e-2 of
    the CPU's, the JAX suite's optimality bound for it."""
    from repro_torch.core.fit import fit
    from repro_torch.data.synthetic import (classification_problem,
                                            lasso_problem)
    from repro_torch.exec import problems as exprob
    from repro_torch.service import registry

    lp = lasso_problem(SEED, SMALL["N"], SMALL["m_per_node"], SMALL["n"],
                       device="cpu")
    cp = classification_problem(SEED, SMALL["N"], SMALL["m_per_node"],
                                SMALL["n"], device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    cls = torch.randint(0, 3, (SMALL["N"], SMALL["m_per_node"]),
                        generator=gen).float()
    mu = float(lp.mu)

    def args(problem):
        if problem in ("lasso", "ridge", "elastic_net", "nnls", "huber",
                       "quantile", "group_lasso"):
            D, a = lp.D, lp.b
        elif problem == "multinomial":
            D, a = cp.D, cls
        else:
            D, a = cp.D, cp.labels
        kw = dict(iters=SMALL_ITERS)
        if problem in ("lasso", "elastic_net", "group_lasso"):
            kw["mu"] = mu
        if problem == "sparse_logistic":
            kw["mu"] = 2.0
        if problem == "elastic_net":
            kw["l2"] = 0.1 * mu
        return D, a, kw

    def rel(u, v):
        u, v = u.double().cpu(), v.double().cpu()
        return float(torch.linalg.norm(u - v)
                     / max(float(torch.linalg.norm(v)), 1e-30))

    def hold(label, rg, rc, hg, hc, kind):
        """kind: "run" (x after a fixed number of steps), "solve" (stops
        by Boyd's rule: the histories up to the earlier stop), "fasta"
        (the history of g + J, which passes through 0, relative to its
        largest value). The stop points are printed, not held: where the
        residuals reach the f32 noise floor they follow rounding."""
        ig, ic = int(rg.iters), int(rc.iters)
        ok = bool(torch.isfinite(rg.x).all()) and rg.x.device.type == \
            "cuda" and tuple(rg.x.shape) == tuple(rc.x.shape)
        ex = rel(rg.x, rc.x)
        ok &= ex <= 2e-4
        eh = 0.0
        if hc is not None:
            hg, hc = hg.double().cpu(), hc.double().cpu()
            k = min(ig, ic) if kind == "solve" else len(hc)
            ok &= kind == "solve" or len(hg) == len(hc)
            den = hc.abs().max() if kind == "fasta" else hc[:k].abs()
            eh = float(((hg[:k] - hc[:k]).abs() / den).max())
            ok &= eh <= 1e-4
        check(ok, f"{label}: card vs CPU iters {ig}/{ic}, x rel {ex:.2e}, "
              f"history rel {eh:.2e}")

    t0 = time.perf_counter()
    for problem, method in sorted(registry._REGISTRY):
        D, a, kw = args(problem)
        if (problem, method) == ("svm", "consensus"):
            kw["iters"] = 40
        t1 = time.perf_counter()
        rg = fit(problem, D, a, method=method, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rc = fit(problem, D, a, method=method, device="cpu", **kw)
        label = f"registry {problem}/{method} ({t2 - t1:.2f} s on the card)"
        if (problem, method) == ("svm", "consensus"):
            og = float(rg.objective_history[-1])
            oc = float(rc.objective_history[-1])
            check(math.isfinite(og) and abs(og - oc) <= 2e-2 * abs(oc),
                  f"{label}: final objective {og:.6g} vs CPU {oc:.6g} "
                  f"(rel {abs(og - oc) / abs(oc):.2e} <= 2e-2; z rel "
                  f"{rel(rg.x, rc.x):.2e})")
            continue
        kind = "solve" if problem in ("group_lasso", "multinomial") else \
            "fasta" if problem in ("lasso", "elastic_net", "nnls") and \
            method != "consensus" else "run"
        hold(label, rg, rc, rg.objective_history, rc.objective_history,
             kind)
    for name in ("logistic", "svm", "least_squares", "quantile",
                 "group_lasso", "multinomial"):
        p = exprob.make_problem(name)
        D, a = exprob.synth_data(p, m=SMALL["N"] * SMALL["m_per_node"],
                                 n=SMALL["n"], seed=SEED)
        rg = exprob.fit_on_executor(p, "local", D, a, max_iters=300,
                                    record=True)
        rc = exprob.fit_on_executor(p, "local", D, a, max_iters=300,
                                    record=True, device="cpu")
        hold(f"executor {name}/local", rg, rc, rg.history.objective,
             rc.history.objective, "solve")
    print(f"registry and executor problems: card and CPU in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_lasso_timing(torch, rt, reps: int):
    """K2b at the lasso's shape (r = 1) against its plain version and one
    product D^T [D | b] (which holds [G | c]); no target."""
    from repro_torch.kernels.gram import ops as gram_ops

    D2, b2 = rt["lasso"]
    m, n = D2.shape
    timer = Timer(torch, reps)
    (G1, C1), (G2, C2) = gram_ops.gram_and_rhs(D2, b2), \
        gram_ops.gram_and_rhs_plain(D2, b2)
    err = max(float((G1 - G2).abs().max()), float((C1 - C2).abs().max()))
    e = max(gram_err(torch, G1, G2), rel_err(torch, C1, C2))
    check(e <= 1e-4, f"K2b at {m}x{n}: err {e:.2e} <= 1e-4 of its plain "
          "version")
    del G1, C1, G2, C2
    k_ms = timer(lambda: gram_ops.gram_and_rhs(D2, b2))
    p_ms = timer(lambda: gram_ops.gram_and_rhs_plain(D2, b2))
    DB = torch.cat([D2, b2[:, None]], 1)
    lib_ms = timer(lambda: D2.T @ DB)
    del DB
    free_device_memory(torch)
    record(rt, "K2b_gram_and_rhs_lasso", err, k_ms, p_ms,
           bound(rt, m * n * 4 + m * 4 + n * n * 4 + n * 4,
                 m * n * n + 2 * m * n), lib_ms)
    print(f"K2b at the lasso shape: {k_ms:.3f} ms, "
          f"{m * n * n / k_ms / 1e9:.1f} TFLOP/s of m n^2; "
          f"D.T @ [D | b] {lib_ms:.3f} ms", flush=True)


# Phase 14, the fit service on phase 6's lasso: 64 ridge probes with fresh
# labels in windows of 16, a lasso path of 64 mus from mu_max down to the
# 10 % rule's mu, one logistic full solve of 50 iterations, 48 requests
# over TCP from two tenants (then 24 with seeded slow-backend chaos), a
# 64-row block ingested and retired, and the CLI at 2^20 x 200
SERVICE = dict(probes=64, window=16, ridge_mu=1.0, path=64, full_iters=50,
               tcp=48, chaos=24, chaos_slow_ms=3000.0, cold_budget_s=1.5,
               block=64, cli_rows=1 << 20, cli_requests=24, cli_iters=200)


def phase_service(torch, rt, D, b, mu):
    """Phase 14: ``FitServer`` over phase 6's lasso (registration through
    K2b, warm ridge probes and a lasso path with no Gram pass, a logistic
    full solve through K3, ingest / retire through K2b and the rank-k
    factor update), ``FitFrontend`` on loopback with and without chaos,
    and ``launch.serve_fit``."""
    import hashlib
    import threading

    import numpy as np

    from repro_torch.cluster.chaos import FaultEvent, FaultInjector
    from repro_torch.core.fasta import transpose_reduction_lasso
    from repro_torch.core.oracles import default_tau
    from repro_torch.core.prox import make_logistic
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.kernels.admm_iter import ops as iter_ops
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.launch import serve_fit
    from repro_torch.service import FitRequest, FitServer, batching
    from repro_torch.service import stats as stats_mod
    from repro_torch.service.frontend import (SERVICE_DATA_PLANE,
                                              FitFrontend, FitServiceClient)

    sv = SERVICE
    t_phase = time.perf_counter()
    D2, b2 = rt["lasso"]
    G64, c64 = rt["lasso64"]
    m, n = D2.shape
    dev = D2.device
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    k2b, k3 = gram_ops.gram_and_rhs, iter_ops.admm_iter_full

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # 1. register: K2b timed by CUDA events, the fingerprint by the clock
    real_stats, real_fp = stats_mod.gram_stats, stats_mod._content_fingerprint
    split = {}

    def timed_stats(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_stats(*a, **k)
        e1.record()
        e1.synchronize()
        split["k2b_ms"] = e0.elapsed_time(e1)
        return out

    def timed_fp(*a):
        t0 = time.perf_counter()
        out = real_fp(*a)
        split["fp_s"] = time.perf_counter() - t0
        return out

    srv = FitServer(window=sv["window"], device=dev)
    stats_mod.gram_stats, stats_mod._content_fingerprint = timed_stats, \
        timed_fp
    zero_counts(k2b)
    t0 = time.perf_counter()
    fp = srv.register_dataset(D, b)
    reg_s = sync_s(t0)
    stats_mod.gram_stats, stats_mod._content_fingerprint = real_stats, \
        real_fp
    st = srv.stats_for(fp)
    e_g = gram_err(torch, st.G, G64)
    dg = torch.sqrt(torch.diagonal(G64))
    bb = float(torch.sum(b2.double() ** 2))
    e_c = float(((st.c.double() - c64).abs() / (dg * math.sqrt(bb))).max())
    check(k2b.launches == 1 and srv.counters.gram_passes == 1
          and e_g <= 1e-5 and e_c <= 1e-5,
          f"service register {m}x{n}: K2b {k2b.launches} launch, "
          f"gram_passes {srv.counters.gram_passes}; (G, c) vs f64 "
          f"{e_g:.2e} / {e_c:.2e} <= 1e-5")
    print(f"service register: {reg_s:.3f} s = K2b {split['k2b_ms']:.2f} ms "
          f"+ fingerprint (D2H + sha256 of {D2.numel() * 4 / 1e9:.1f} GB) "
          f"{split['fp_s']:.3f} s + rest", flush=True)
    # the fingerprint's parts at 1 GiB: the pageable D2H, the host copy of
    # tobytes() and sha256 on one host thread
    probe = D2.reshape(-1)[:1 << 28]
    t0 = time.perf_counter()
    host = probe.cpu().numpy()
    d2h = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = host.tobytes()
    cp = time.perf_counter() - t0
    t0 = time.perf_counter()
    hashlib.sha256(raw).hexdigest()
    sha = time.perf_counter() - t0
    gb = probe.numel() * 4 / 1e9
    print(f"service fingerprint parts, GB/s: D2H {gb / d2h:.2f}, "
          f"tobytes {gb / cp:.2f}, sha256 {gb / sha:.2f}", flush=True)
    del probe, host, raw

    # 2. ridge probes with fresh labels: one rhs pass a window, one factor
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    Bp = torch.randn((m, sv["probes"]), generator=g, device=dev)
    probes = Bp.T.contiguous().cpu().numpy()
    reqs = [FitRequest(problem="ridge", fingerprint=fp, b=probes[j],
                       mu=sv["ridge_mu"]) for j in range(sv["probes"])]
    zero_counts(k2b)
    t0 = time.perf_counter()
    resp = srv.serve(reqs)
    probe_s = sync_s(t0)
    c = srv.counters
    windows = sv["probes"] // sv["window"]
    check(len(resp) == sv["probes"] and all(r.status == "ok" for r in resp)
          and c.rhs_passes == windows and c.factorizations == 1
          and c.gram_passes == 1 and k2b.launches == 0,
          f"service probes: {len(resp)} ok, rhs_passes {c.rhs_passes} = "
          f"{windows}, factorizations {c.factorizations}, gram_passes "
          f"{c.gram_passes}, K2b {k2b.launches}")
    C64 = torch.zeros((n, sv["probes"]), dtype=torch.float64, device=dev)
    for s0 in range(0, m, 1 << 20):
        C64 += D2[s0:s0 + (1 << 20)].double().T @ \
            Bp[s0:s0 + (1 << 20)].double()
    X64 = torch.linalg.solve(G64 + sv["ridge_mu"] * eye, C64).T
    X = torch.from_numpy(np.stack([r.x for r in resp])).to(dev).double()
    e = float((torch.linalg.norm(X - X64, dim=1)
               / torch.linalg.norm(X64, dim=1)).max())
    check(e <= 1e-4, f"service probes vs f64 closed form: rel {e:.2e} "
          "<= 1e-4")
    warm = c.snapshot()["fit_latency_ms"]["warm"]
    print(f"service probes: {sv['probes']} in {probe_s:.3f} s = "
          f"{probe_s / sv['probes'] * 1e3:.2f} ms/request (numpy b, H2D "
          f"included); warm p50 {warm['p50']:.1f} ms", flush=True)
    # one window's parts, each as the server runs it: the label vectors'
    # H2D (pageable numpy, stacked on the card; host clock, median of 3),
    # the rhs pass (one GEMM on the card), beside a sum of 4 row-block
    # GEMMs, and the triangular solve pair on the cached factor (CUDA
    # events)
    win = list(probes[:sv["window"]])
    h2d = []
    for _ in range(3):
        t0 = time.perf_counter()
        Bw = torch.stack([srv._tensor(v) for v in win], 1)
        h2d.append(sync_s(t0))
    q = -(-m // 4)
    timer = Timer(torch, REPS)
    rhs_ms = timer(lambda: batching.rhs_chunked(D2, Bw))
    four = lambda: sum(D2[s0:s0 + q].T @ Bw[s0:s0 + q]
                       for s0 in range(0, m, q))
    four_ms = timer(four)
    Cw = batching.rhs_chunked(D2, Bw)
    Cw64 = C64[:, :sv["window"]]
    rhs_err = lambda C: float((C.double() - Cw64).abs().max()
                              / Cw64.abs().max())
    e_four = rhs_err(four())
    e = rhs_err(Cw)
    check(e <= 1e-4, f"service rhs pass at {m}x{n}x{sv['window']} vs f64: "
          f"{e:.2e} <= 1e-4 (4 blocks {e_four:.2e})")
    L = srv._factors[(fp, float(sv["ridge_mu"]))]
    tri_ms = timer(lambda: batching.batched_gram_solve(L, Cw.T))
    rb = bound(rt, (m * n + m * sv["window"] + n * sv["window"]) * 4,
               2 * m * n * sv["window"])
    win_ms = probe_s / windows * 1e3
    h2d_ms = statistics.median(h2d) * 1e3
    print(f"service probe window of {sv['window']}: {win_ms:.1f} ms on "
          f"average in the serve; apart: H2D {h2d_ms:.1f} ms "
          f"({len(win) * m * 4 / h2d_ms / 1e6:.2f} GB/s), rhs_chunked "
          f"{rhs_ms:.3f} ms (4 blocks {four_ms:.3f}; bound {rb[0]:.3f} ms, "
          f"{rb[1]}), triangular solve {tri_ms:.3f} ms", flush=True)
    del Bp, probes, reqs, resp, C64, X64, X, win, Bw, Cw, Cw64

    # 3. the lasso path: one lane-batched FASTA, each lane against its own
    # single solve and the KKT conditions in float64
    mus = mu * torch.logspace(1.0, 0.0, sv["path"], dtype=torch.float64)
    t0 = time.perf_counter()
    Xp, its = batching.batched_quad_prox(
        st.G, st.c.expand(sv["path"], n), mus, kind="lasso",
        iters=LASSO_ITERS)
    path_s = sync_s(t0)
    t0 = time.perf_counter()
    singles = [transpose_reduction_lasso(st.G, st.c, float(u),
                                         iters=LASSO_ITERS)
               for u in mus.tolist()]
    single_s = sync_s(t0)
    e_x = max(float(((Xp[j] - r.x).abs() - 1e-3 * r.x.abs()).max())
              for j, r in enumerate(singles))
    corr = G64 @ Xp.double().T - c64[:, None]
    viol = float((corr.abs().max(0).values - mus.to(dev)).max() / mu)
    its = its.tolist()
    check(e_x <= 1e-4 and viol <= 1e-3 and bool(torch.isfinite(Xp).all()),
          f"service mu path: {sv['path']} lanes, max(|dx| - 1e-3 |x|) "
          f"{e_x:.2e} <= 1e-4 vs single solves; KKT {viol:.2e} mu <= "
          f"1e-3 mu")
    print(f"service mu path: {path_s * 1e3 / sv['path']:.2f} ms/solve "
          f"batched ({path_s:.3f} s, iters {min(its)}-{max(its)}), "
          f"{single_s * 1e3 / sv['path']:.2f} ms/solve alone", flush=True)
    del Xp, singles, corr

    # 4. a logistic full solve through the server: K3 every iteration
    labels = torch.sign(b2)
    lab_np = labels.cpu().numpy()
    k2a = gram_ops.gram
    zero_counts(k3)
    zero_counts(k2a)
    t0 = time.perf_counter()
    (rl,) = srv.serve([FitRequest(problem="logistic", fingerprint=fp,
                                  b=lab_np, iters=sv["full_iters"])])
    full_s = sync_s(t0)
    launches, ring, k2a_n = k3.launches, k3.launches_ring, k2a.launches
    rt["launches"]["K3_admm_iter_lasso"] = launches
    ref = UnwrappedADMM(loss=make_logistic(), tau=default_tau("logistic", m),
                        eps_rel=0.0, eps_abs=0.0, device=str(dev)).solve(
        D, labels.reshape(D.shape[:2]), max_iters=sv["full_iters"])
    xr = ref.x.cpu().numpy()
    e = float(np.abs(rl.x - xr).max() / max(np.abs(xr).max(), 1e-30))
    check(rl.status == "ok" and launches == ring == sv["full_iters"]
          and k2a_n == 1 and e <= 1e-6 and srv.counters.full_solves == 1,
          f"service logistic: K3 {launches} launches ({ring} ring) = "
          f"{sv['full_iters']} iterations, K2a {k2a_n} (the Gram); x vs "
          f"UnwrappedADMM.solve {e:.2e} <= 1e-6")
    print(f"service logistic: {full_s:.3f} s for {sv['full_iters']} iters "
          f"({full_s * 1e3 / sv['full_iters']:.2f} ms/iter, setup "
          "included)", flush=True)
    # K3 at this shape, from the solve's x (y = D x, a small lam), against
    # its plain version
    delta = 1.0 / default_tau("logistic", m)
    xk = ref.x.to(dev).float()
    yk = D2 @ xk
    lk = 0.01 * torch.randn((m,), generator=g, device=dev)
    k3f = lambda: k3(D2, labels, yk, lk, xk, kind="logistic", delta=delta)
    p3f = lambda: iter_ops.admm_iter_plain(D2, labels, yk, lk, xk,
                                           kind="logistic", delta=delta)
    o1, o2 = k3f(), p3f()
    e_yl = max(rel_err(torch, o1[0], o2[0]), rel_err(torch, o1[1], o2[1]))
    e_dwv = max(float((u - v).abs().max() / v.abs().max().clamp(min=1))
                for u, v in zip(o1[2:], o2[2:]))
    check(iter_ops.route(m, n, D2.dtype) == "ring" and e_yl <= 4e-6
          and e_dwv <= 1e-4,
          f"K3 at {m}x{n} (ring): y/lam err {e_yl:.2e} <= 4e-6, d/w/v err "
          f"{e_dwv:.2e} <= 1e-4")
    err = max(float((u - v).abs().max()) for u, v in zip(o1, o2))
    del o1, o2
    k3_ms = timer(k3f)
    record(rt, "K3_admm_iter_lasso", err, k3_ms, timer(p3f),
           bound(rt, m * n * 4 + 5 * m * 4 + 4 * n * 4,
                 m * (8 * n + logistic_flops(delta))), None)
    per_it = full_s * 1e3 / sv["full_iters"]
    print(f"service logistic: {per_it:.2f} ms/iter = K3 {k3_ms:.3f} ms + "
          f"{per_it - k3_ms:.2f} ms (the setup's K2a and factor spread over "
          "the iterations, the driver)", flush=True)
    del xk, yk, lk

    # 5. over TCP: two tenants, no chaos (all ok), then seeded chaos
    def drive(fe, total, tag, tenants=("t0", "t1")):
        lat, out, lock = [], [], threading.Lock()

        def tenant(k):
            with FitServiceClient(fe.address, tenant=tenants[k],
                                  timeout=60.0) as cl:
                for i in range(k, total, len(tenants)):
                    if i % 3 == 0:
                        kw = dict(problem="logistic", b=lab_np,
                                  iters=sv["full_iters"])
                    elif i % 3 == 1:
                        kw = dict(problem="ridge", mu=sv["ridge_mu"],
                                  b=probe_b[i % len(probe_b)])
                    else:
                        kw = dict(problem="lasso", mu=mu, iters=LASSO_ITERS)
                    problem = kw.pop("problem")
                    t0 = time.perf_counter()
                    r = cl.fit(problem, fp, timeout=300.0, **kw)
                    with lock:
                        lat.append(time.perf_counter() - t0)
                        out.append((i, problem, r))

        ths = [threading.Thread(target=tenant, args=(k,))
               for k in range(len(tenants))]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=600.0)
        check(not any(t.is_alive() for t in ths) and len(out) == total,
              f"service {tag}: {len(out)} of {total} answered")
        statuses = {}
        for _, _, r in out:
            statuses[r["status"]] = statuses.get(r["status"], 0) + 1
        return out, np.asarray(lat) * 1e3, statuses

    rng = np.random.default_rng(SEED + 14)
    probe_b = [rng.standard_normal(m).astype(np.float32) for _ in range(4)]
    zero_counts(k3)
    zero_counts(k2a)
    errors0 = srv.counters.errors
    t0 = time.perf_counter()
    with FitFrontend(server=srv, max_frame_bytes=256 << 20,
                     cold_budget_s=120.0) as fe:
        out, lat, statuses = drive(fe, sv["tcp"], "tcp")
        zero_lost = fe.zero_lost_requests()
    tcp_s = time.perf_counter() - t0
    x_log = [r["x"] for _, p, r in out if p == "logistic"]
    e = max(float(np.abs(x - rl.x).max()) for x in x_log) / max(
        float(np.abs(rl.x).max()), 1e-30)
    same = all(np.array_equal(x, rl.x) for x in x_log)
    check(statuses == {"ok": sv["tcp"]} and zero_lost
          and srv.counters.errors == errors0 and k3.launches > 0
          and e <= 1e-5,
          f"service tcp: statuses {statuses}, zero lost {zero_lost}, "
          f"errors {srv.counters.errors - errors0}, K3 {k3.launches} "
          f"launches; logistic x vs step 4's {e:.1e} <= 1e-5 (bitwise "
          f"{same})")
    print(f"service tcp: {sv['tcp']} requests from 2 tenants in "
          f"{tcp_s:.2f} s; latency p50 {np.percentile(lat, 50):.1f} ms, "
          f"p99 {np.percentile(lat, 99):.1f} ms; K3 {k3.launches}, K2a "
          f"{k2a.launches} launches", flush=True)

    crng = np.random.default_rng(SEED + 14)
    points = sorted(int(p) for p in crng.choice(
        np.arange(1, sv["chaos"] + 1, 3), 3, replace=False))
    chaos = FaultInjector([FaultEvent(p, "svc", "slow", sv["chaos_slow_ms"])
                           for p in points], data_plane=SERVICE_DATA_PLANE)
    t0 = time.perf_counter()
    fe = FitFrontend(server=srv, max_frame_bytes=256 << 20, chaos=chaos,
                     cold_budget_s=sv["cold_budget_s"])
    out, lat, statuses = drive(fe, sv["chaos"], "chaos", tenants=("t0",))
    zero_lost = fe.zero_lost_requests()
    fe.close()
    fe._cold_pool.shutdown(wait=True)     # the slowed solves run to the end
    chaos_s = time.perf_counter() - t0
    check(statuses.get("degraded", 0) >= 1 and zero_lost
          and set(statuses) <= {"ok", "degraded"},
          f"service chaos (slow cold backend at fits {points}): statuses "
          f"{statuses}, zero lost {zero_lost}")
    print(f"service chaos: {sv['chaos']} requests in {chaos_s:.2f} s; "
          f"latency p50 {np.percentile(lat, 50):.1f} ms, p99 "
          f"{np.percentile(lat, 99):.1f} ms", flush=True)
    del labels, lab_np, probe_b, out, x_log

    # 6. ingest and retire a labeled block with one live factor (K2b a
    # block; the rank-64 Cholesky update is a host loop of small launches)
    key = (fp, float(sv["ridge_mu"]))
    check(list(srv._factors) == [key], f"service: one live factor "
          f"({len(srv._factors)})")
    blk = torch.randn((sv["block"], n), generator=g, device=dev)
    blk_b = torch.randn((sv["block"],), generator=g, device=dev)
    updates0 = srv.counters.factor_updates

    def factor_err(fpk):
        L = srv._factors[(fpk, key[1])].double()
        Lf = torch.linalg.cholesky(srv.stats_for(fpk).G.double()
                                   + key[1] * eye)
        return float(torch.linalg.norm(L - Lf) / torch.linalg.norm(Lf))

    zero_counts(k2b)
    t0 = time.perf_counter()
    fp2 = srv.ingest_block(fp, blk, blk_b)
    ing_s, ing_k2b = sync_s(t0), k2b.launches
    e_in = factor_err(fp2)
    zero_counts(k2b)
    t0 = time.perf_counter()
    fp3 = srv.retire_block(fp2, blk, blk_b)
    ret_s, ret_k2b = sync_s(t0), k2b.launches
    e_out = factor_err(fp3)
    check(ing_k2b == ret_k2b == 1 and fp2 != fp and fp3 == fp
          and srv.counters.factor_updates - updates0 == 2
          and e_in <= 1e-4 and e_out <= 1e-4
          and srv.stats_for(fp3).rows == m,
          f"service ingest / retire {sv['block']} rows: K2b {ing_k2b} + "
          f"{ret_k2b}, factor_updates 2, fingerprint back to the "
          f"original; L vs a fresh factor {e_in:.2e} / {e_out:.2e} <= 1e-4")
    print(f"service ingest {ing_s:.2f} s, retire {ret_s:.2f} s (rank-"
          f"{sv['block']} Cholesky up/downdate at n = {n})", flush=True)
    check(srv.counters.errors == 0, "service: errors 0")
    del srv, st, blk, blk_b
    free_device_memory(torch)

    # 7. the CLI at 2^20 x 200: in process (probes, then the mu path), then
    # networked
    base = ["--rows", str(sv["cli_rows"]), "--features", str(n),
            "--iters", str(sv["cli_iters"]), "--device", str(dev)]
    t0 = time.perf_counter()
    r1 = serve_fit.main(base + ["--requests", "64"])
    r2 = serve_fit.main(base + ["--requests", "64", "--mu-path"])
    r3 = serve_fit.main(base + ["--port", "0", "--requests",
                                str(sv["cli_requests"])])
    cli_s = time.perf_counter() - t0
    c1 = r1["counters"]
    check(c1["gram_passes"] == 1 and c1["errors"] == 0
          and c1["responses"] == 64 and r2["counters"]["gram_passes"] == 1
          and bool(torch.isfinite(r2["X"]).all())
          and r3["statuses"] == {"ok": sv["cli_requests"]}
          and r3["zero_lost"],
          f"service CLI at {sv['cli_rows']}x{n}: probes, mu path, "
          f"networked {r3['statuses']} (zero lost {r3['zero_lost']}) in "
          f"{cli_s:.1f} s")
    print(f"service phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# The sparse data path (DESIGN.md section 10) at benchmarks/sparse_bench.py's
# width and density: n = 512 features at 1 %, cut to m = 2^22 rows (the
# host build of the layout, ~30 s, is what bounds m)
SPARSE = dict(m=1 << 22, n=512, density=0.01)
SPARSE_CLI = dict(nodes=16, rows_per_node=65536, iters=100)   # 2^20 rows
# The column-split dual lasso (paper section 7.1):
# tests/test_column_split.py's wide problem at m = 2,048 rows x 32 nodes of
# 8,192 columns
COLUMN_SPLIT = dict(m=2048, nodes=32, cols_per_node=8192, iters=3000)
# K6's d/w/v against its plain version, on random iterates (at a solution
# u = y' - y is rounding noise, which the two prox chains round
# differently), relative to sum |D| |u|, the sum of the absolute terms,
# element by element: 2e-5 at the small shapes; at the full shape the
# plain version adds 810 block partials in f32 without compensation, up to
# nb 2^-24 ~ 5e-5 of that sum, so 1e-4 there
K6_DWV_SMALL, K6_DWV_FULL = 2e-5, 1e-4


def k6_errs(torch, sp_ops, D, y, out, plain):
    """(y/lam error relative to max(1, max |plain|), d/w/v error relative
    to sum |D| |u| element by element) of a K6 call against its plain
    version."""
    e_yl = max(rel_err(torch, u, v) for u, v in zip(out[:2], plain[:2]))
    absD = dataclasses.replace(D, values=D.values.abs(),
                               col_values=D.col_values.abs())
    us = [plain[0] - plain[1], plain[0] - y, plain[1]]
    e_dwv = 0.0
    for u, v, w in zip(out[2:], plain[2:], us):
        if v is None:
            continue
        terms = sp_ops.rmatvec(absD, w.abs()).double()
        e_dwv = max(e_dwv, float(((u.double() - v.double()).abs()
                                  / terms.clamp(min=1e-30)).max()))
    return e_yl, e_dwv


def phase_sparse_kernels(torch):
    """K6 against its plain version at small shapes: all five kinds, f32
    and bf16 values, want_dual on and off; a tail block, zero-nnz rows
    (rows 1024-3071: an all-zero block where block_m = 1024), duplicate
    column ids, block_m 1024 (u in shared memory), 40,000 (u outside it)
    and the autotuned height at n = 512; two identical calls bit for
    bit."""
    import numpy as np
    from repro_torch.data.sparse import BlockCSR, _random_coo
    from repro_torch.kernels.spgram import ops as sp_ops

    dev = torch.device("cuda")
    k6 = sp_ops.sparse_admm_iter_full
    rng = np.random.default_rng(SEED)
    for m, n, block_m, density in ((5000, 64, 1024, 0.05),
                                   (70001, 130, 40000, 0.02),
                                   (30001, 512, None, 0.01)):
        rows, cols = _random_coo(rng, m, n, density)
        keep = (rows < 1024) | (rows >= 3072)
        rows, cols = rows[keep], cols[keep]
        rows = np.concatenate([rows, rows[:64]])     # duplicate entries
        cols = np.concatenate([cols, cols[:64]])
        vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
        D = BlockCSR.from_coo(rows, cols, vals, m, n, block_m=block_m,
                              device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED)
        y, lam = (torch.randn(m, generator=g, device=dev) for _ in range(2))
        x = 0.1 * torch.randn(n, generator=g, device=dev)
        aux = torch.sign(torch.randn(m, generator=g, device=dev))
        for dt in (torch.float32, torch.bfloat16):
            Dd = D.astype(dt)
            for kind in KINDS:
                a = None if kind == "l1" else aux
                p = 0.3 if kind == "quantile" else 0.0
                for dual in (True, False):
                    kw = dict(kind=kind, delta=2.0, param=p, want_dual=dual)
                    before = k6.launches
                    o1 = k6(Dd, a, y, lam, x, **kw)
                    o2 = k6(Dd, a, y, lam, x, **kw)
                    op = sp_ops.sparse_admm_iter_plain(Dd, a, y, lam, x,
                                                       **kw)
                    e_yl, e_dwv = k6_errs(torch, sp_ops, Dd, y, o1, op)
                    same = all(u is v or torch.equal(u, v)
                               for u, v in zip(o1, o2))
                    where = "shared" if sp_ops.u_in_shared(Dd, dual) \
                        else "L2"
                    check(e_yl <= 2e-5 and e_dwv <= K6_DWV_SMALL and same
                          and k6.launches - before == 2
                          and (o1[3] is None) == (not dual),
                          f"K6 sparse_admm_iter {kind:13s} m={m} n={n} "
                          f"bm={Dd.block_m} kp={Dd.kp} kc={Dd.kc} "
                          f"{str(dt)[6:]} dual={int(dual)} u in {where}"
                          f": y/lam err {e_yl:.2e} <= 2e-5, d/w/v err "
                          f"{e_dwv:.2e} <= {K6_DWV_SMALL:g} of sum |terms|, "
                          "bitwise repeat")


def phase_sparse(torch, rt, reps: int, sp=SPARSE, cli=SPARSE_CLI,
                 cs=COLUMN_SPLIT):
    """The sparse data path at full size through K6, the CLI's --density,
    and the column-split dual lasso through K2a (module docstring, phase
    7)."""
    from repro_torch.core.prox import make_hinge, make_logistic
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.data.sparse import sparse_classification_problem
    from repro_torch.kernels.admm_iter import ops as iter_ops
    from repro_torch.kernels.spgram import ops as sp_ops

    t0 = time.perf_counter()
    prob = sparse_classification_problem(SEED, sp["m"], sp["n"],
                                         sp["density"])
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    D, lab = prob.D, prob.labels
    m, n = D.shape
    print(f"sparse: {D}; {D.nbytes / 1e9:.3f} GB on the card (dense "
          f"{m * n * 4 / 1e9:.1f} GB); data {data_s:.1f} s", flush=True)
    check(D.nnz > 0 and bool(torch.isfinite(D.values).all()),
          "sparse data: nonzeros, finite values")

    logistic = dict(loss=make_logistic(), tau=0.1)
    svm = dict(loss=make_hinge(1.0), tau=0.5, rho=1.0)
    k6 = sp_ops.sparse_admm_iter_full
    # each solve's Gram (a host pass) timed where the engine calls it
    real_gram_rhs, gram_s = sp_ops.sparse_gram_rhs, []

    def timed_gram_rhs(*a, **k):
        t = time.perf_counter()
        out = real_gram_rhs(*a, **k)
        torch.cuda.synchronize()
        gram_s.append(time.perf_counter() - t)
        return out

    sp_ops.sparse_gram_rhs = timed_gram_rhs
    zero_counts(k6)
    runs = {}
    for label, kw, extra in (("f32", logistic, {}),
                             ("bf16", logistic, {"residency": "bf16"}),
                             ("svm", svm, {})):
        solver = UnwrappedADMM(**kw, **extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(D, lab, max_iters=ITERS)
        torch.cuda.synchronize()
        runs[label] = (res, time.perf_counter() - t0, gram_s[-1])
    launches = k6.launches
    sp_ops.sparse_gram_rhs = real_gram_rhs
    total = sum(r[0].iters for r in runs.values())
    check(launches == total, f"sparse path: K6 launched {launches} times "
          f"= {total} iterations")
    rt["launches"]["K6_sparse_admm_iter"] = launches
    base = m * math.log(2.0)           # the logistic objective at x = 0
    for label, (res, secs, g_s) in runs.items():
        check(bool(torch.isfinite(res.x).all()) and res.x.shape == (n,)
              and res.y.shape == (1, m),
              f"sparse {label}: x finite, shape ({n},), y (1, {m})")
        z = sp_ops.matvec(D, res.x).double()
        a = lab.double()
        acc = float(torch.mean((torch.sign(z) == a).double()))
        if label == "svm":
            obj = float(torch.sum(torch.clamp(1 - a * z, min=0))
                        + 0.5 * torch.dot(res.x.double(), res.x.double()))
        else:
            obj = float(torch.sum(torch.nn.functional.softplus(-a * z)))
        per_iter = (secs - g_s) * 1e3 / max(res.iters, 1)
        print(f"sparse {label}: {res.iters} iters, objective {obj:.6g}, "
              f"train acc {acc:.4f}, gram {g_s:.2f} s (host), "
              f"{per_iter:.2f} ms/iter, solve {secs:.2f} s", flush=True)
        if label != "svm":
            check(obj < base, f"sparse {label}: objective {obj:.6g} < "
                  f"{base:.6g} (x = 0)")

    # x against the densify oracle (backend "reference": D densified on the
    # card each pass) at equal iteration counts, and against the same
    # oracle in float64 on a densified copy
    res_c = runs["f32"][0]
    ref_solver = UnwrappedADMM(**logistic, backend="reference")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_r = ref_solver.solve(D, lab, max_iters=res_c.iters)
    torch.cuda.synchronize()
    print(f"sparse oracle (reference backend, densified each pass): "
          f"{res_r.iters} iters in {time.perf_counter() - t0:.2f} s",
          flush=True)
    # the stop points are printed, not held: where the residuals reach the
    # f32 noise floor they follow rounding (phase 6's registry checks)
    print(f"sparse stop iteration: K6 {res_c.iters}, oracle {res_r.iters} "
          f"(run to at most K6's)", flush=True)
    k = res_r.iters
    if k != res_c.iters:
        res_c = UnwrappedADMM(**logistic).solve(D, lab, max_iters=k)
    res_b = runs["bf16"][0]
    if res_b.iters != k:
        res_b = UnwrappedADMM(**logistic, residency="bf16").solve(
            D, lab, max_iters=k)
    D64 = D.to_dense().double()
    res_64 = UnwrappedADMM(**logistic, backend="reference").solve(
        D64[None], lab.double()[None], max_iters=k)
    del D64
    free_device_memory(torch)

    def rel(u, v):
        return float(torch.linalg.norm(u.double() - v.double())
                     / torch.linalg.norm(v.double()))

    x64 = res_64.x
    e_c, e_r, e_b = rel(res_c.x, x64), rel(res_r.x, x64), rel(res_b.x, x64)
    e_cr = rel(res_c.x, res_r.x)
    print(f"sparse x after {k} iters: f64 oracle stopped at "
          f"{res_64.iters}; f32 oracle vs f64 {e_r:.2e}", flush=True)
    check(e_cr <= 1e-3, f"sparse K6 x vs the f32 densify oracle: rel "
          f"{e_cr:.2e} <= 1e-3")
    check(e_c <= 1e-4, f"sparse K6 x vs the f64 oracle: rel {e_c:.2e} "
          "<= 1e-4")
    check(e_b <= 5e-3, f"sparse bf16 residency x vs the f64 oracle: rel "
          f"{e_b:.2e} <= 5e-3")

    # K6 timed at this shape, f32 and bf16: the solution's x, random y and
    # lam (see K6_DWV_FULL)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    y, lam = (torch.randn(m, generator=g, device="cuda") for _ in range(2))
    x = res_c.x
    delta = 1.0 / logistic["tau"]
    del runs, res_r, res_b, res_64
    timer = Timer(torch, reps)
    nflops = 8 * D.nnz + m * PROX_FLOPS["logistic"]
    times = {}
    for label, DD in (("f32", D), ("bf16", D.astype(torch.bfloat16))):
        k6_fn = lambda: k6(DD, lab, y, lam, x, kind="logistic", delta=delta)
        p6_fn = lambda: sp_ops.sparse_admm_iter_plain(
            DD, lab, y, lam, x, kind="logistic", delta=delta)
        o1, o2, op = k6_fn(), k6_fn(), p6_fn()
        e_yl, e_dwv = k6_errs(torch, sp_ops, DD, y, o1, op)
        same = all(torch.equal(u, v) for u, v in zip(o1, o2))
        check(e_yl <= 4e-6 and e_dwv <= K6_DWV_FULL and same,
              f"K6 at {m}x{n} {label}: y/lam err {e_yl:.2e} <= 4e-6, "
              f"d/w/v err {e_dwv:.2e} <= {K6_DWV_FULL:g} of sum |terms|, "
              "bitwise repeat")
        err = max(float((u - v).abs().max()) for u, v in zip(o1, op))
        del o1, o2, op
        # the CSR and CSC as stored (padding included); y, lam, aux read,
        # y', lam' written; x read, d, w, v written
        nbytes = DD.nbytes + 5 * m * 4 + 4 * n * 4
        tb = bound(rt, nbytes, nflops)
        times[label] = (timer(k6_fn), timer(p6_fn), tb, err)
        t = times[label][0]
        print(f"time K6 [{label} values] at {m}x{n} (nb {DD.nblocks}, bm "
              f"{DD.block_m}, kp {DD.kp}, kc {DD.kc}, nnz {DD.nnz}, u in "
              f"{'shared' if sp_ops.u_in_shared(DD) else 'L2'}): kernel "
              f"{t:.3f} ms, {nbytes / t / 1e6:.0f} GB/s of "
              f"{nbytes / 1e9:.3f} GB, bound {tb[0]:.3f} ms ({tb[1]}), "
              f"plain {times[label][1]:.3f} ms", flush=True)
    del k6_fn, p6_fn, DD
    k_ms, p_ms, tb, err = times["f32"]
    record(rt, "K6_sparse_admm_iter", err, k_ms, p_ms, tb, None)
    # probe: K3 on the densified copy (the reference's sparse_bench
    # comparison of the two formats)
    Dd = D.to_dense()
    k3_ms = timer(lambda: iter_ops.admm_iter_full(
        Dd, lab, y, lam, x, kind="logistic", delta=delta))
    route = iter_ops.route(m, n, Dd.dtype)
    print(f"probe: K3 on the densified {m}x{n} copy "
          f"({Dd.numel() * 4 / 1e9:.1f} GB, route {route}): {k3_ms:.3f} "
          f"ms; K6 on the BlockCSR {k_ms:.3f} ms ({k3_ms / k_ms:.2f}x)",
          flush=True)
    del Dd, D, lab, prob, y, lam, x, res_c
    print(f"sparse: freed, {free_device_memory(torch):.2f} GB still "
          "allocated", flush=True)

    phase_sparse_cli(torch, cli, sp)
    phase_column_split(torch, rt, reps, cs)


def phase_sparse_cli(torch, cli, sp):
    """``launch.fit.main --density`` for logistic and lasso on the card,
    the result lines held: the logistic objective below its value at
    x = 0, the lasso's KKT violation at most 1e-3 mu."""
    import contextlib
    import io
    import re
    from repro_torch.launch import fit as fit_cli

    rows = cli["nodes"] * cli["rows_per_node"]
    for problem in ("logistic", "lasso"):
        argv = ["--density", str(sp["density"]), "--problem", problem,
                "--nodes", str(cli["nodes"]), "--rows-per-node",
                str(cli["rows_per_node"]), "--features", str(sp["n"]),
                "--iters", str(cli["iters"]), "--seed", str(SEED)]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = fit_cli.main(argv)
        secs = time.perf_counter() - t0
        out = buf.getvalue()
        for line in out.strip().splitlines():
            print(f"cli {problem}: {line}", flush=True)
        ok = bool(torch.isfinite(res.x).all()) and res.x.is_cuda
        if problem == "lasso":
            mt = re.search(r"KKT violation: (\S+) \(mu (\S+)\)", out)
            viol, mu = float(mt.group(1)), float(mt.group(2))
            check(ok and viol <= 1e-3 * mu,
                  f"cli lasso --density at {rows} rows: KKT violation "
                  f"{viol:.3g} <= 1e-3 mu ({1e-3 * mu:.3g}); {secs:.1f} s")
        else:
            obj = float(re.search(r"objective: (\S+),", out).group(1))
            check(ok and obj < rows * math.log(2.0),
                  f"cli logistic --density at {rows} rows: objective "
                  f"{obj:.6g} < {rows * math.log(2.0):.6g} (x = 0); "
                  f"{secs:.1f} s")
        del res
    free_device_memory(torch)


def phase_column_split(torch, rt, reps: int, cs):
    """The column-split dual lasso on a wide Gaussian problem built like
    tests/test_column_split.py::_wide_problem (numpy, from the seed): one
    K2a launch (the Gram of D_hat = [I; D^T]), then the iterations on the
    engine's reference body; that file's certificates, in float64 on the
    card; K2a timed at D_hat's shape."""
    import numpy as np
    from repro_torch.core.column_split import lasso_column_split
    from repro_torch.kernels.gram import ops as gram_ops

    m, N, ni, iters = cs["m"], cs["nodes"], cs["cols_per_node"], cs["iters"]
    n = N * ni
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    Dn = rng.standard_normal((m, n), dtype=np.float32)
    Dn *= np.float32(1.0 / math.sqrt(m))
    x_true = np.zeros((n,), np.float32)
    x_true[rng.permutation(n)[:8]] = 1.0
    bn = Dn @ x_true + np.float32(0.05) * rng.standard_normal(
        m, dtype=np.float32)
    mu = 0.1 * float(np.abs(Dn.T @ bn).max())
    D = torch.from_numpy(Dn).cuda()
    b = torch.from_numpy(bn).cuda()
    del Dn
    torch.cuda.synchronize()
    print(f"column split: m {m} x n {n} ({N} nodes of {ni} columns), f32 "
          f"({m * n * 4 / 1e9:.2f} GB; D_hat {(m + n) * m * 4 / 1e9:.2f} "
          f"GB), mu {mu:.6g}; data {time.perf_counter() - t0:.1f} s",
          flush=True)
    zero_counts(gram_ops.gram)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lasso_column_split(D.reshape(m, N, ni).permute(1, 0, 2), b, mu,
                             tau=1.0, iters=iters)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = gram_ops.gram.launches
    check(launches == 1, f"column split: K2a launched {launches} time(s) "
          "= 1 Gram of D_hat")
    rt["launches"]["K2a_gram_column_split"] = launches
    D64, b64 = D.double(), b.double()
    x64, a64 = res.x.double(), res.alpha.double()
    feas = float((D64.T @ a64).abs().max())
    corr = D64.T @ (D64 @ x64 - b64)
    viol = max(float(corr.abs().max()) - mu, 0.0)
    sup = x64.abs() > 1e-7
    sup_err = float((corr[sup] + mu * torch.sign(x64[sup])).abs().max()) \
        if bool(sup.any()) else 0.0
    del D64, corr
    print(f"column split: {iters} iterations in {secs:.2f} s "
          f"({secs * 1e3 / iters:.3f} ms/iter with the setup), Boyd's rule "
          f"first held at {res.iters}; support {int(sup.sum())}", flush=True)
    check(bool(torch.isfinite(res.x).all()) and feas <= 1.01 * mu,
          f"column split: ||D^T alpha||_inf {feas:.6g} <= 1.01 mu "
          f"({1.01 * mu:.6g})")
    check(viol < 0.02 * mu and sup_err < 0.05 * mu,
          f"column split KKT: violation {viol:.3g} < 0.02 mu "
          f"({0.02 * mu:.3g}), support err {sup_err:.3g} < 0.05 mu "
          f"({0.05 * mu:.3g})")
    del res

    # K2a at D_hat's shape against its plain version and D_hat.T @ D_hat
    Dh = torch.cat([torch.eye(m, device=D.device), D.T])
    del D
    rows = Dh.shape[0]
    timer = Timer(torch, reps)
    G1, G2 = gram_ops.gram(Dh), gram_ops.gram_plain(Dh)
    e = gram_err(torch, G1, G2)
    check(e <= 1e-5 and torch.equal(G1, gram_ops.gram(Dh)),
          f"K2a at D_hat's {rows}x{m}: err {e:.2e} <= 1e-5, bitwise repeat")
    err = float((G1 - G2).abs().max())
    del G1, G2
    k_ms = timer(lambda: gram_ops.gram(Dh))
    lib_ms = timer(lambda: Dh.T @ Dh)
    record(rt, "K2a_gram_column_split", err, k_ms,
           timer(lambda: gram_ops.gram_plain(Dh)),
           bound(rt, rows * m * 4 + m * m * 4, rows * m * m), lib_ms)
    print(f"K2a at D_hat's shape: {k_ms:.3f} ms, "
          f"{rows * m * m / k_ms / 1e9:.1f} TFLOP/s of m n^2; "
          f"D_hat.T @ D_hat {lib_ms:.3f} ms", flush=True)
    del Dh, b
    print(f"column split: freed, {free_device_memory(torch):.2f} GB still "
          "allocated", flush=True)


# Out-of-core (DESIGN.md section 9): the star catalog at full width held in
# a host block store whose block height fits a 4096 MiB device budget (20
# blocks of 870,128 rows, the tail padded); the paper's data never fit one
# device. Resume, the sparse store (phase 7's CLI data), the stats path
# (the lasso at 4,194,304 x 200) and the CLI at 2^20 rows beside it.
OOC = dict(rows=M_MAIN, n=307, budget_mb=4096, iters=20, min_host_gb=64)
OOC_RESUME = dict(rows=1 << 20, iters=30, every=10)
OOC_SPARSE = dict(m=1 << 20, n=512, density=0.01)
# (the rank-k Cholesky update is a host loop of ~13 small launches a
# column: 256 rows, cut from 1,000, keep it to ~10-30 s each way)
OOC_STATS = dict(nodes=64, rows_per_node=65536, n=200, chol_rows=256)
OOC_CLI = dict(nodes=16, rows_per_node=65536, n=200, budget_mb=512,
               every=10, iters=25)
# peak device memory of a streamed solve above its baseline: the budget's
# four D blocks and six block vectors, plus n-sized buffers (G, its factor,
# x and the d/w/v accumulators, K3's per-CTA partials) and the caching
# allocator's rounding of each live block up to its 2 MiB granule
OOC_SLACK = 16 << 20


def host_gb() -> float:
    """MemAvailable of this machine, in GiB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2 ** 20
    fail("no MemAvailable in /proc/meminfo")


def host_store(torch, D2, a, br):
    """A host ShardedMatrixStore of a card-resident (m, n) D and its labels,
    copied block by block, each block fingerprinted at write time as
    ``from_arrays`` does (the hashes in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.data.store import ShardedMatrixStore, fingerprint_array
    m = D2.shape[0]
    blocks = [D2[s:s + br].cpu().numpy() for s in range(0, m, br)]
    auxs = [a[s:s + br].cpu().numpy() for s in range(0, m, br)]
    with ThreadPoolExecutor(8) as pool:
        fps = list(pool.map(fingerprint_array, blocks, auxs))
    return ShardedMatrixStore(blocks, auxs, br, fps)


def rel_norm(torch, u, v) -> float:
    return float(torch.linalg.norm(u.double() - v.double())
                 / torch.linalg.norm(v.double()))


def phase_ooc(torch, rt, reps: int):
    """Phase 8: the out-of-core path (module docstring)."""
    avail = host_gb()
    rows = OOC["rows"]
    cut = ""
    if avail < OOC["min_host_gb"]:
        rows //= 2
        cut = f" (halved: under {OOC['min_host_gb']} GiB available)"
    print(f"ooc: host memory available {avail:.1f} GiB; star catalog at "
          f"{rows} rows{cut}", flush=True)
    data = phase_ooc_dense(torch, rt, reps, rows)
    cluster = save_cluster_stores(data)
    phase_ooc_resume(torch)
    phase_ooc_sparse(torch, rt, reps)
    cluster["stats"] = phase_ooc_stats(torch, cluster["dir"])
    phase_ooc_cli(torch)
    return cluster


def phase_ooc_dense(torch, rt, reps: int, rows: int):
    """The star catalog streamed from a host store through K2a and K3:
    against the in-memory solve, overlap on and off bit for bit, the peak
    device memory against the budget, and the sweep's three streams
    timed apart."""
    from repro_torch.core.prox import make_logistic
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.data.synthetic import star_catalog_problem
    from repro_torch.engine import StreamingEngine, autotune
    from repro_torch.engine.streaming import block_step_fns
    from repro_torch.kernels.admm_iter import ops as iter_ops
    from repro_torch.kernels.gram import ops as gram_ops

    n, iters = OOC["n"], OOC["iters"]
    budget = OOC["budget_mb"] << 20
    delta = 10.0
    t0 = time.perf_counter()
    prob = star_catalog_problem(SEED, 1, rows)
    D3, lab = prob.D, prob.labels
    D2, a = D3.reshape(rows, n), lab.reshape(rows)
    br = autotune.streaming_block_rows(rows, n, torch.float32,
                                       budget_bytes=budget)
    store = host_store(torch, D2, a, br)
    nb, dbytes = store.nblocks, rows * n * 4
    print(f"ooc: {store}, {store.nbytes / 1e9:.2f} GB on the host in "
          f"{time.perf_counter() - t0:.1f} s; block {br} rows "
          f"({br * n * 4 / 1e9:.3f} GB), pad {nb * br - rows} rows",
          flush=True)
    check(nb == -(-rows // br) and store.m == rows,
          f"ooc store: {nb} blocks of {br} rows hold {rows} rows")

    solver = UnwrappedADMM(loss=make_logistic(), tau=0.1, eps_rel=1e-12,
                           eps_abs=1e-15)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mem = solver.solve(D3, lab, max_iters=iters, record=True)
    torch.cuda.synchronize()
    mem_s = time.perf_counter() - t0
    check(mem.iters == iters, f"in-memory solve: {mem.iters} = {iters} "
          f"iterations in {mem_s:.2f} s")
    # phase 10's fault runs: the first rows of the same data, in memory
    # (their yardstick) and as a host store of their own block height
    fr = CLUSTER["fault_rows"]
    sub = solver.solve(D3[:, :fr], lab[:, :fr], max_iters=iters,
                       record=True)
    check(sub.iters == iters, f"in-memory solve at {fr} rows: {sub.iters} "
          f"= {iters} iterations")
    sub_store = host_store(torch, D2[:fr], a[:fr], CLUSTER["fault_block"])

    # K3 at the store-block shape (a full block; the tail is padded to it)
    Db, ab = D2[:br], a[:br]
    yb = mem.y.reshape(-1)[:br].contiguous()
    lb = mem.lam.reshape(-1)[:br].contiguous()
    x = mem.x
    timer = Timer(torch, reps)
    k3 = lambda: iter_ops.admm_iter_full(Db, ab, yb, lb, x, kind="logistic",
                                         delta=delta)
    p3 = lambda: iter_ops.admm_iter_plain(Db, ab, yb, lb, x,
                                          kind="logistic", delta=delta)
    o1, o2 = k3(), p3()
    e_yl = max(rel_err(torch, o1[0], o2[0]), rel_err(torch, o1[1], o2[1]))
    e_dwv = max(float((u - v).abs().max() / v.abs().max().clamp(min=1))
                for u, v in zip(o1[2:], o2[2:]))
    same = all(torch.equal(u, v) for u, v in zip(o1, k3()))
    check(e_yl <= 4e-6 and e_dwv <= 1e-4 and same,
          f"K3 at the store block {br}x{n}: y/lam err {e_yl:.2e} <= 4e-6, "
          f"d/w/v err {e_dwv:.2e} <= 1e-4, bitwise repeat")
    k3_err = max(float((u - v).abs().max()) for u, v in zip(o1, o2))
    k3_ms, p3_ms = timer(k3), timer(p3)
    k3_bound = bound(rt, br * n * 4 + 5 * br * 4 + 4 * n * 4,
                     br * (8 * n + PROX_FLOPS["logistic"]))
    G64, _ = f64_stats(torch, D2, a)
    del o1, o2, Db, ab, yb, lb, D2, a, D3, lab, prob
    print(f"ooc: the in-memory D freed, "
          f"{free_device_memory(torch):.2f} GB still allocated", flush=True)

    # the streamed solve: counts set to 0 just before, read just after
    for fn in (gram_ops.gram, gram_ops.gram_and_rhs,
               iter_ops.admm_iter_full):
        zero_counts(fn)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    st = solver.solve_streaming(store, max_iters=iters, record=True)
    torch.cuda.synchronize()
    st_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    k2a_n, k3_n = gram_ops.gram.launches, iter_ops.admm_iter_full.launches
    check(k2a_n == nb and gram_ops.gram_and_rhs.launches == 0,
          f"streamed Gram: K2a launched {k2a_n} times = {nb} blocks")
    check(st.iters == iters and k3_n == nb * iters,
          f"streamed solve: K3 launched {k3_n} times = {nb} blocks x "
          f"{iters} iterations")
    rt["launches"]["K3_admm_iter_store_block"] = k3_n
    e_x = rel_norm(torch, st.x, mem.x)
    ho, hm = st.history.objective.double(), mem.history.objective.double()
    e_obj = float(((ho - hm).abs() / hm.abs()).max())
    print(f"ooc streamed: {iters} iterations in {st_s:.2f} s (in memory "
          f"{mem_s:.2f} s); objective {float(ho[-1]):.9g} (in memory "
          f"{float(hm[-1]):.9g})", flush=True)
    check(e_x <= 1e-4, f"streamed x vs the in-memory x: rel {e_x:.2e} "
          "<= 1e-4")
    check(e_obj <= 1e-5, f"streamed objective history vs in-memory: rel "
          f"{e_obj:.2e} <= 1e-5")
    blocks4 = 4 * br * n * 4
    print(f"ooc peak device memory above the baseline: {peak / 2**20:.1f} "
          f"MiB (four D blocks {blocks4 / 2**20:.1f} MiB, budget "
          f"{budget / 2**20:.0f} MiB)", flush=True)
    check(peak <= budget + OOC_SLACK,
          f"streamed peak {peak / 2**20:.1f} MiB <= budget "
          f"{budget / 2**20:.0f} MiB + {OOC_SLACK / 2**20:.0f} MiB slack")
    Gs = StreamingEngine(engine=solver.engine).gram_from_store(store)
    e_g = gram_err(torch, Gs, G64)
    check(e_g <= 1e-5, f"gram_from_store ({nb} K2a launches) vs a float64 "
          f"Gram: err {e_g:.2e} <= 1e-5")
    del Gs, G64
    off = solver.solve_streaming(store, max_iters=iters, record=True,
                                 overlap=False)
    check(all(torch.equal(getattr(st, f), getattr(off, f))
              for f in ("x", "y", "lam")),
          "overlap on and off: x, y and lam bit-identical")
    del off

    # the sweep's three streams apart, one sweep each after a warm-up
    eng = solver.engine
    seng = StreamingEngine(engine=eng, prefetch=2)
    naive = StreamingEngine(engine=eng, prefetch=0)
    y = seng.host_buffer((rows,), torch.float32)
    lam = seng.host_buffer((rows,), torch.float32)
    y.copy_(st.y[0])
    lam.copy_(st.lam[0])
    x = st.x

    def sweep_s(se):
        torch.cuda.synchronize()
        t = time.perf_counter()
        se.sweep(store, x, y, lam)
        return time.perf_counter() - t

    sweep_s(seng)
    sweep_s(naive)
    db_s, nv_s = sweep_s(seng), sweep_s(naive)
    seng.stage_seconds = 0.0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _, D_b in seng.stream_blocks(store):
        D_b = None
    torch.cuda.synchronize()
    tr_s, stage_s = time.perf_counter() - t, seng.stage_seconds
    step, _, _ = block_step_fns(eng, True)
    blk = next(iter(seng.stream_blocks(store)))[1]
    vec = lambda: torch.zeros(br, device="cuda")
    yv, lv, av = vec(), vec(), torch.ones(br, device="cuda")
    from repro_torch.engine.streaming import _zero_sweep
    acc = _zero_sweep(n, torch.float32, 1, "cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(nb):
        yn, ln, acc = step(blk, av, yv, lv, x, acc)
    torch.cuda.synchronize()
    cp_s = time.perf_counter() - t
    del blk, yv, lv, av, yn, ln, acc
    h = torch.empty(2 ** 28, dtype=torch.float32, pin_memory=True)
    dv = torch.empty(2 ** 28, dtype=torch.float32, device="cuda")
    h2d_ms = timer(lambda: dv.copy_(h, non_blocking=True))
    h2d = 2 ** 30 / (h2d_ms / 1e3)
    del h, dv
    sweep_bound = max(dbytes / h2d, nb * k3_bound[0] / 1e3)
    gbs = lambda sec: (f"{dbytes / sec / 1e9:.2f} GB/s" if sec > 0
                       else "not measured")
    print(f"ooc sweep of bytes(D) {dbytes / 1e9:.3f} GB in {nb} blocks: "
          f"double-buffered {db_s:.3f} s ({gbs(db_s)}), naive (prefetch 0) "
          f"{nv_s:.3f} s ({gbs(nv_s)}); transfer only {tr_s:.3f} s "
          f"({gbs(tr_s)}), host staging {stage_s:.3f} s ({gbs(stage_s)}), "
          f"compute only {cp_s:.3f} s ({gbs(cp_s)}); pinned H2D of 1 GiB "
          f"{h2d_ms:.3f} ms ({h2d / 1e9:.2f} GB/s); sweep bound "
          f"{sweep_bound:.3f} s (max of bytes(D) / H2D, {nb} x K3's byte "
          f"floor {k3_bound[0]:.3f} ms)", flush=True)
    record(rt, "K3_admm_iter_store_block", k3_err, k3_ms, p3_ms, k3_bound,
           None)
    data = {"store": store, "x": mem.x, "sub_store": sub_store,
            "sub_x": sub.x, "sub_obj": float(sub.history.objective[-1])}
    del seng, naive, y, lam, st, mem, store, sub, sub_store
    print(f"ooc dense: freed, {free_device_memory(torch):.2f} GB still "
          "allocated", flush=True)
    return data


def phase_ooc_resume(torch):
    """An uninterrupted checkpointed streamed solve against one killed at
    20 iterations and resumed: x, y and lam bit-identical; a checkpoint of
    another store refused."""
    import tempfile

    from repro_torch.core.prox import make_logistic
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.data.synthetic import star_catalog_problem
    from repro_torch.engine import autotune

    rows, iters, every = (OOC_RESUME[k] for k in ("rows", "iters", "every"))
    prob = star_catalog_problem(SEED, 1, rows)
    D2, a = prob.D.reshape(rows, -1), prob.labels.reshape(rows)
    br = autotune.streaming_block_rows(rows, D2.shape[1], torch.float32)
    store = host_store(torch, D2, a, br)
    other = host_store(torch, D2.flip(0), a.flip(0), br)
    del prob, D2, a
    solver = UnwrappedADMM(loss=make_logistic(), tau=0.1, eps_rel=1e-12,
                           eps_abs=1e-15)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        full = solver.solve_streaming(store, max_iters=iters,
                                      checkpoint_dir=f"{tmp}/a",
                                      checkpoint_every=every)
        full_s = time.perf_counter() - t0
        solver.solve_streaming(store, max_iters=20,
                               checkpoint_dir=f"{tmp}/b",
                               checkpoint_every=every)
        back = solver.solve_streaming(store, max_iters=iters, resume=True,
                                      checkpoint_dir=f"{tmp}/b",
                                      checkpoint_every=every)
        same = all(torch.equal(getattr(full, f), getattr(back, f))
                   for f in ("x", "y", "lam"))
        check(full.iters == back.iters == iters and same,
              f"resume at {rows} rows ({store.nblocks} blocks): 20 + 10 "
              f"iterations bit-identical to {iters} in one run "
              f"({full_s:.2f} s)")
        refused = ""
        try:
            solver.solve_streaming(other, max_iters=iters, resume=True,
                                   checkpoint_dir=f"{tmp}/b")
        except ValueError as e:
            refused = str(e)
        check("different store" in refused,
              f"a checkpoint of another store is refused ({refused})")


def phase_ooc_sparse(torch, rt, reps: int):
    """Phase 7's CLI data (2^20 x 512 at 1 %) in a sparse store: streamed
    logistic through K6 (one CTA per store block) against the in-memory
    sparse solve, and K6 at the store-block shape."""
    from repro_torch.core.prox import make_logistic
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.data.sparse import sparse_classification_problem
    from repro_torch.data.store import ShardedMatrixStore
    from repro_torch.engine import StreamingEngine
    from repro_torch.kernels.spgram import ops as sp_ops

    sp = OOC_SPARSE
    prob = sparse_classification_problem(SEED, sp["m"], sp["n"],
                                         sp["density"])
    D, lab = prob.D, prob.labels
    m, n = D.shape
    t0 = time.perf_counter()
    store = ShardedMatrixStore.from_sparse(D, lab)
    print(f"ooc sparse: {store} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    k6 = sp_ops.sparse_admm_iter_full
    solver = UnwrappedADMM(loss=make_logistic(), tau=0.1)
    mem = solver.solve(D, lab, max_iters=ITERS)
    zero_counts(k6)
    t0 = time.perf_counter()
    st = solver.solve_streaming(store, max_iters=ITERS)
    torch.cuda.synchronize()
    st_s = time.perf_counter() - t0
    launches = k6.launches
    check(launches == store.nblocks * st.iters,
          f"sparse store: K6 launched {launches} times = "
          f"{store.nblocks} blocks x {st.iters} iterations")
    rt["launches"]["K6_sparse_admm_iter_store_block"] = launches
    e_x = rel_norm(torch, st.x, mem.x)
    check(e_x <= 1e-4 and abs(st.iters - mem.iters) <= 5,
          f"sparse store x vs in-memory: rel {e_x:.2e} <= 1e-4; "
          f"iterations {st.iters} vs {mem.iters} (within 5)")
    seng = StreamingEngine(engine=solver.engine)
    y = seng.host_buffer((m,), torch.float32)
    lam = seng.host_buffer((m,), torch.float32)
    seng.sweep(store, st.x, y, lam)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seng.sweep(store, st.x, y, lam)
    sw_s = time.perf_counter() - t0
    print(f"ooc sparse: {st.iters} iterations in {st_s:.2f} s with the "
          f"host Gram; one sweep of {store.nblocks} blocks {sw_s:.3f} s "
          f"({sw_s / store.nblocks * 1e3:.3f} ms a block, "
          f"{store.nbytes / sw_s / 1e9:.2f} GB/s of {store.nbytes / 1e9:.3f}"
          f" GB)", flush=True)
    # K6 at the store-block shape: one block (nb 1), random iterates
    Bh, ah = store.block(0, padded=True)
    B = Bh.to("cuda")
    a_b = torch.from_numpy(ah).cuda()
    bm = B.m
    g = torch.Generator(device="cuda").manual_seed(SEED)
    yb, lb = (torch.randn(bm, generator=g, device="cuda") for _ in range(2))
    x = st.x
    k6_fn = lambda: k6(B, a_b, yb, lb, x, kind="logistic", delta=10.0)
    p6_fn = lambda: sp_ops.sparse_admm_iter_plain(B, a_b, yb, lb, x,
                                                  kind="logistic",
                                                  delta=10.0)
    o1, o2, op = k6_fn(), k6_fn(), p6_fn()
    e_yl, e_dwv = k6_errs(torch, sp_ops, B, yb, o1, op)
    same = all(torch.equal(u, v) for u, v in zip(o1, o2))
    check(e_yl <= 4e-6 and e_dwv <= K6_DWV_SMALL and same,
          f"K6 at the store block ({bm}x{n}, nb 1, kp {B.kp}, kc {B.kc}): "
          f"y/lam err {e_yl:.2e} <= 4e-6, d/w/v err {e_dwv:.2e} <= "
          f"{K6_DWV_SMALL:g} of sum |terms|, bitwise repeat")
    err = max(float((u - v).abs().max()) for u, v in zip(o1, op))
    timer = Timer(torch, reps)
    nnz = int((B.values != 0).sum())
    tb = bound(rt, B.nbytes + 5 * bm * 4 + 4 * n * 4,
               8 * nnz + bm * PROX_FLOPS["logistic"])
    record(rt, "K6_sparse_admm_iter_store_block", err, timer(k6_fn),
           timer(p6_fn), tb, None)
    del o1, o2, op, B, a_b, yb, lb, st, mem, D, lab, prob, store, seng
    free_device_memory(torch)


def phase_ooc_stats(torch, save_dir):
    """SufficientStats.from_store on the lasso at 4,194,304 x 200 (one K2b
    launch per block), FASTA on it, and the Cholesky rank-k update and
    downdate of a 256-row block against a fresh factor. The store is
    saved under ``save_dir`` for phase 10; returns its path, fingerprint
    and the float64 (G, c)."""
    from repro_torch.core.fasta import transpose_reduction_lasso
    from repro_torch.core.gram import gram_factor
    from repro_torch.data.synthetic import lasso_problem
    from repro_torch.engine import autotune
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.launch.fit import lasso_kkt_gap
    from repro_torch.service.stats import (
        SufficientStats,
        chol_downdate,
        chol_update,
    )

    cfg = OOC_STATS
    n = cfg["n"]
    prob = lasso_problem(SEED, cfg["nodes"], cfg["rows_per_node"], n,
                         heterogeneity=1.0)
    D2, b = prob.D.reshape(-1, n), prob.b.reshape(-1)
    m, mu = D2.shape[0], float(prob.mu)
    br = autotune.streaming_block_rows(m, n, torch.float32)
    store = host_store(torch, D2, b, br)
    zero_counts(gram_ops.gram)
    zero_counts(gram_ops.gram_and_rhs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = SufficientStats.from_store(store)
    torch.cuda.synchronize()
    st_s = time.perf_counter() - t0
    k2b = gram_ops.gram_and_rhs.launches
    check(k2b == store.nblocks and gram_ops.gram.launches == 0
          and stats.fingerprint == store.fingerprint
          and stats.fully_labeled and stats.rows == m,
          f"stats from the store ({store.nblocks} blocks of {br} rows): K2b "
          f"launched {k2b} times, fingerprint folded, {st_s:.2f} s")
    G64, c64 = f64_stats(torch, D2, b)
    e_g = gram_err(torch, stats.G, G64)
    e_c = rel_err(torch, stats.c, c64)
    check(e_g <= 1e-5 and e_c <= 1e-5, f"stats (G, c) vs float64: "
          f"{e_g:.2e}, {e_c:.2e} <= 1e-5")
    saved = {"path": store.save(f"{save_dir}/lasso"),
             "fingerprint": store.fingerprint, "rows": m,
             "G64": G64, "c64": c64}
    t0 = time.perf_counter()
    fr = transpose_reduction_lasso(stats.G, stats.c, mu, iters=LASSO_ITERS)
    torch.cuda.synchronize()
    fa_s = time.perf_counter() - t0
    viol, _ = lasso_kkt_gap(D2, b, fr.x, mu)
    check(viol <= 1e-3 * mu, f"stats-path lasso: FASTA {int(fr.iters)} "
          f"iterations in {fa_s:.3f} s, KKT violation {viol:.3g} <= 1e-3 mu "
          f"({1e-3 * mu:.3g})")
    k = cfg["chol_rows"]
    B, bb = D2[:k], b[:k]
    L = stats.factor()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_up = chol_update(L, B)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    L_fresh = gram_factor(stats.update(B, bb).G)
    t0 = time.perf_counter()
    L_dn = chol_downdate(L_up, B)
    torch.cuda.synchronize()
    dn_s = time.perf_counter() - t0
    rl = lambda u, v: float((u - v).abs().max() / v.abs().max())
    e_up, e_dn = rl(L_up, L_fresh), rl(L_dn, L)
    check(e_up <= 1e-4 and e_dn <= 1e-4,
          f"rank-{k} Cholesky update {e_up:.2e} ({up_s:.2f} s) and "
          f"downdate {e_dn:.2e} ({dn_s:.2f} s) vs a fresh factor <= 1e-4")
    del D2, b, prob, store, stats, G64, c64, L, L_up, L_dn, L_fresh, B, bb
    free_device_memory(torch)
    return saved


def phase_ooc_cli(torch):
    """``launch.fit.main --executor streaming`` at 2^20 rows for 25
    iterations with a checkpoint every 10, then the same command with
    ``--resume`` (from iteration 20): both return, with the same x."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import fit as fit_cli

    c = OOC_CLI
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--executor", "streaming", "--device-budget-mb",
                str(c["budget_mb"]), "--checkpoint-dir", f"{tmp}/ckpt",
                "--checkpoint-every", str(c["every"]), "--nodes",
                str(c["nodes"]), "--rows-per-node", str(c["rows_per_node"]),
                "--features", str(c["n"]), "--iters", str(c["iters"]),
                "--seed", str(SEED)]
        outs = []
        for extra in ([], ["--resume"]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = fit_cli.main(argv + extra)
            secs = time.perf_counter() - t0
            for line in buf.getvalue().strip().splitlines():
                print(f"cli streaming{' --resume' if extra else ''}: "
                      f"{line}", flush=True)
            outs.append((res, secs))
        (r1, s1), (r2, s2) = outs
        check(r1.x.is_cuda and bool(torch.isfinite(r1.x).all())
              and torch.equal(r1.x, r2.x),
              f"cli --executor streaming at {c['nodes'] * c['rows_per_node']}"
              f" rows: {r1.iters} iterations ({s1:.1f} s), then --resume "
              f"({s2:.1f} s): the same x")
    free_device_memory(torch)


# The cluster runtime (DESIGN.md section 11) on phase 8's data: the star
# catalog saved to a directory (tmpfs when it has room) and memory-mapped
# by worker processes that share the card. Main solve: 4 workers over
# phase 8's 20 blocks, 20 iterations, observability on. Faults and
# compression at the first 4,194,304 rows (8 blocks of 524,288); the stats
# path on phase 8's lasso store; the CLI at 2^20 x 200.
CLUSTER = dict(workers=4, iters=20, fault_rows=1 << 22, fault_block=1 << 19,
               die_worker=2, die_at=8, compress_workers=2, stats_workers=2,
               cli_nodes=16, cli_rows=65536, cli_n=200, cli_iters=10,
               heartbeat_timeout_s=120, register_timeout_s=300,
               tmpfs="/dev/shm")
# a worker's span may open this long before the coordinator's collect span
# of the same iteration: the broadcast is sent just before the span opens,
# and the coordinator's thread can wait several of the interpreter's 5 ms
# switch intervals for its lock (its receiver threads unpickle heartbeats)
SPAN_SLACK_US = 50_000


def save_cluster_stores(data):
    """Save phase 8's star-catalog stores for phase 10 to a directory (tmpfs
    when it has room, else the temporary directory) and drop the in-RAM
    copies, so the host holds the data once when the workers map it."""
    import shutil
    import tempfile

    need = data["store"].nbytes + data["sub_store"].nbytes
    base, tmpfs = tempfile.gettempdir(), CLUSTER["tmpfs"]
    if Path(tmpfs).is_dir() and shutil.disk_usage(tmpfs).free > 2 * need:
        base = tmpfs
    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_", dir=base)
    t0 = time.perf_counter()
    out = {"dir": root, "x": data["x"], "sub_x": data["sub_x"],
           "sub_obj": data["sub_obj"],
           "main": data["store"].save(f"{root}/star"),
           "sub": data["sub_store"].save(f"{root}/star_sub")}
    print(f"cluster: stores saved under {root} ({need / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s; in-RAM copies freed",
          flush=True)
    data.clear()
    gc.collect()
    return out


def phase_obs_main(torch, rt):
    """The main path with observability on and off: ``UnwrappedADMM.solve``
    on phase 4's D for 20 iterations, x bit-identical, 20 telemetry
    records stamped ``local``; ms/iter of both, one clock each."""
    import tempfile

    from repro_torch.core.prox import make_logistic
    from repro_torch.core.unwrapped import UnwrappedADMM
    from repro_torch.obs import TELEMETRY_FILE, Observability, read_jsonl

    D, lab = rt["main"][:2]
    iters = CLUSTER["iters"]
    solver = UnwrappedADMM(loss=make_logistic(), tau=0.1, eps_rel=1e-12,
                           eps_abs=1e-15)
    solver.solve(D, lab, max_iters=2)            # warm-up
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for label in ("off", "on"):
            obs = Observability(dir=tmp, process_name="chip_smoke") \
                if label == "on" else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solver.solve(D, lab, max_iters=iters, obs=obs)
            torch.cuda.synchronize()
            runs[label] = (res, (time.perf_counter() - t0) * 1e3 / iters)
            if obs is not None:
                obs.finish()
        recs = [r for r in read_jsonl(f"{tmp}/{TELEMETRY_FILE}")
                if "iter" in r]
    (off, off_ms), (on, on_ms) = runs["off"], runs["on"]
    print(f"obs main path: {iters} iterations, {off_ms:.2f} ms/iter obs "
          f"off, {on_ms:.2f} ms/iter obs on (setup included)", flush=True)
    check(on.iters == off.iters == iters and torch.equal(on.x, off.x),
          "obs on/off on the main path: x bit-identical after "
          f"{iters} iterations")
    check(len(recs) == iters and all(r["executor"] == "local"
                                     for r in recs),
          f"obs on: {len(recs)} telemetry records, each stamped local")


def phase_cluster(torch, rt, cl):
    """Phase 10: the cluster runtime on phase 8's data (module docstring)."""
    import contextlib
    import io
    import shutil

    from repro_torch.cluster.coordinator import (
        ClusterConfig,
        ClusterCoordinator,
        cluster_solve,
        cluster_stats,
    )
    from repro_torch.exec import ClusterExecutor
    from repro_torch.launch import fit as fit_cli
    from repro_torch.launch import obs_report
    from repro_torch.obs import (
        TELEMETRY_FILE,
        TRACE_FILE,
        load_trace,
        merged_histogram,
        read_jsonl,
        snapshot_histograms,
    )

    c = CLUSTER
    t_phase = time.perf_counter()
    tiny = dict(eps_rel=1e-12, eps_abs=1e-15)
    limits = dict(heartbeat_timeout_s=c["heartbeat_timeout_s"],
                  register_timeout_s=c["register_timeout_s"])
    logistic = {"name": "logistic"}
    dev = torch.device("cuda")
    root = cl["dir"]
    try:
        # -- the main solve: 4 workers, observability on -------------------
        obs_dir = f"{root}/obs"
        coord = ClusterCoordinator(cl["main"], logistic, tau=0.1, **tiny,
                                   config=ClusterConfig(
                                       n_workers=c["workers"],
                                       obs_dir=obs_dir, **limits))
        store = coord.store
        t0 = time.perf_counter()
        coord.start()
        spawn_s = time.perf_counter() - t0
        ex = ClusterExecutor(coord)
        res, setup_s, it_ms, _ = clocked_solve(
            ex, coord, dev, c["iters"], obs=coord.obs, record=True, **tiny)
        wall = time.perf_counter() - t0
        tel = coord._telemetry(res.iters, wall)
        collects = [e["dur"] for e in coord.obs.tracer.events()
                    if e.get("ph") == "X" and e["name"] == "collect"]
        coord.shutdown()
        per = coord._per_worker_telemetry()
        snap = coord.obs.registry.snapshot()
        steps = merged_histogram(snapshot_histograms(
            snap, "worker.block_step_s"))
        e_x = rel_norm(torch, res.x, cl["x"])
        print(f"cluster main: {store.m} x {store.n} in {store.nblocks} "
              f"blocks of {store.block_rows} rows over {c['workers']} "
              f"workers sharing the card; spawn + register {spawn_s:.2f} s, "
              f"setup (stats reduce, K2b per block) {setup_s:.2f} s, "
              f"{it_ms:.1f} ms/iter (driver's init to its finish), "
              f"collect {statistics.mean(collects) / 1e3:.1f} ms/iter, "
              f"block_step p50 {steps.quantile(0.5) * 1e3:.1f} ms, "
              f"reduction {tel['reduction_rx_bytes_per_iter']:.0f} B/iter "
              f"at the coordinator", flush=True)
        stage_b = sum(w["stage_bytes"] for w in per.values())
        stage_s = sum(w["stage_s"] for w in per.values())
        gbs = lambda b, s: f"{b / s / 1e9:.2f} GB/s" if s else "not measured"
        for wid, w in sorted(per.items()):
            peak = w["peak_device_bytes"]
            peak = "not measured" if peak is None else \
                f"{peak / 2**20:.1f} MiB"
            print(f"cluster worker {wid}: {w['iters']} iterations, "
                  f"block_step p50 {w['block_step_ms']['p50']:.1f} ms, "
                  f"host staging {w['stage_bytes'] / 1e9:.2f} GB in "
                  f"{w['stage_s']:.2f} s "
                  f"({gbs(w['stage_bytes'], w['stage_s'])}), peak device "
                  f"memory {peak}, launches {w['kernel_launches']}",
                  flush=True)
        print(f"cluster staging: {stage_b / 1e9:.1f} GB staged host to card "
              f"by all workers (every block once for the stats and once an "
              f"iteration), {gbs(stage_b, stage_s)} per worker while "
              f"staging; the card took bytes(D) an iteration, "
              f"{gbs(store.m * store.n * 4, it_ms / 1e3)} over the four",
              flush=True)
        check(res.iters == c["iters"] and e_x <= 1e-5,
              f"cluster x vs the in-memory x after {res.iters} iterations: "
              f"rel {e_x:.2e} <= 1e-5")
        launches = {}
        for w in per.values():
            for kname, cnt in w["kernel_launches"].items():
                launches[kname] = launches.get(kname, 0) + cnt
        want = {"K3_ring": store.nblocks * c["iters"],
                "K2b": store.nblocks}
        check(launches == want, f"cluster kernels counted in the workers: "
              f"{launches} == {want}")
        check(not tel["deaths"] and tel["workers_alive"] == c["workers"],
              f"cluster: {tel['workers_alive']} workers alive, no deaths")
        recs = [r for r in read_jsonl(f"{obs_dir}/{TELEMETRY_FILE}")
                if "iter" in r]
        check(len(recs) == c["iters"] and all(r["executor"] == "cluster"
                                              for r in recs),
              f"telemetry: {len(recs)} records, each stamped cluster")
        events = [e for e in load_trace(f"{obs_dir}/{TRACE_FILE}")
                  if e.get("ph") == "X"]
        spans = {}
        for e in events:
            spans.setdefault(e["name"], []).append(e)
        coll = {e["args"]["k"]: e for e in spans.get("collect", [])}

        inner = spans.get("worker_iter", []) + spans.get("block_step", [])
        pids = {e["pid"] for e in inner}
        # how far each worker span starts before / ends after the collect
        # span of its iteration (us; at most the slack when it is under it)
        lead = max(coll[e["args"]["k"]]["ts"] - e["ts"] for e in inner
                   if e["args"]["k"] in coll)
        over = max(e["ts"] + e["dur"] - coll[e["args"]["k"]]["ts"]
                   - coll[e["args"]["k"]]["dur"] for e in inner
                   if e["args"]["k"] in coll)
        check(len(coll) == c["iters"] and len(pids) == c["workers"]
              and len(spans.get("block_step", [])) ==
              store.nblocks * c["iters"]
              and all(e["args"]["k"] in coll for e in inner)
              and lead <= SPAN_SLACK_US and over <= SPAN_SLACK_US,
              f"trace: {len(spans.get('block_step', []))} block_step and "
              f"{len(spans.get('worker_iter', []))} worker_iter spans of "
              f"{len(pids)} workers under the coordinator's "
              f"{len(coll)} collect spans (at most {lead / 1e3:.2f} ms "
              f"before one opens, {over / 1e3:.2f} ms after one closes; "
              f"slack {SPAN_SLACK_US / 1e3:.0f} ms)")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            obs_report.main([obs_dir])
        check(f"iterations: {c['iters']}" in buf.getvalue(),
              "obs_report renders the cluster run directory")
        del coord, ex, res

        # -- SIGKILL of one worker mid-solve ------------------------------
        t0 = time.perf_counter()
        kill = cluster_solve(cl["sub"], None, logistic, tau=0.1,
                             max_iters=c["iters"], **tiny,
                             config=ClusterConfig(
                                 n_workers=c["workers"], worker_overrides={
                                     c["die_worker"]: {
                                         "die_at_iter": c["die_at"]}},
                                 **limits))
        t = kill.telemetry
        e_k = rel_norm(torch, torch.from_numpy(kill.x).to(dev),
                       cl["sub_x"])
        print(f"cluster SIGKILL: worker {c['die_worker']} killed at "
              f"iteration {c['die_at']} of {kill.iters}; deaths "
              f"{t['deaths']}, {t['blocks_reassigned']} blocks reassigned, "
              f"{t['iteration_retries']} retries, recovered in "
              f"{t['recovery']['time_to_recover_s']} s; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(t["deaths"] == [c["die_worker"]] and t["blocks_reassigned"] >= 1
              and kill.iters == c["iters"] and e_k <= 1e-5,
              f"SIGKILL recovered: x vs the in-memory x at "
              f"{c['fault_rows']} rows: rel {e_k:.2e} <= 1e-5")

        # -- int8 error-feedback compression ------------------------------
        t0 = time.perf_counter()
        comp = cluster_solve(cl["sub"], None, logistic, tau=0.1,
                             max_iters=c["iters"], **tiny,
                             config=ClusterConfig(
                                 n_workers=c["compress_workers"],
                                 compress=True, **limits))
        obj = comp.history["objective"][-1]
        e_o = abs(obj - cl["sub_obj"]) / abs(cl["sub_obj"])
        per_iter = comp.telemetry["reduction_rx_bytes_per_iter"]
        print(f"cluster int8: objective {obj:.9g} (plain {cl['sub_obj']:.9g})"
              f", reduction {per_iter:.0f} B/iter, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(e_o <= 2e-2 and per_iter < 3 * 4 * store.n,
              f"compressed objective rel {e_o:.2e} <= 2e-2 and "
              f"{per_iter:.0f} < {3 * 4 * store.n} B/iter")

        # -- sufficient statistics over the cluster ----------------------
        sv = cl["stats"]
        t0 = time.perf_counter()
        st, _ = cluster_stats(sv["path"], None, config=ClusterConfig(
            n_workers=c["stats_workers"], **limits))
        e_g = gram_err(torch, st.G, sv["G64"])
        e_c = rel_err(torch, st.c, sv["c64"])
        check(st.fingerprint == sv["fingerprint"] and st.rows == sv["rows"]
              and e_g <= 1e-5 and e_c <= 1e-5,
              f"cluster stats of the lasso store ({sv['rows']} rows, "
              f"{time.perf_counter() - t0:.1f} s): fingerprint merged, "
              f"(G, c) vs float64 {e_g:.2e}, {e_c:.2e} <= 1e-5")

        # -- the CLI ------------------------------------------------------
        cli_dir = f"{root}/cli_obs"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            r = fit_cli.main(["--executor", "cluster", "--workers", "2",
                              "--obs-dir", cli_dir, "--nodes",
                              str(c["cli_nodes"]), "--rows-per-node",
                              str(c["cli_rows"]), "--features",
                              str(c["cli_n"]), "--iters",
                              str(c["cli_iters"]), "--seed", str(SEED)])
            obs_report.main([cli_dir])
        for line in buf.getvalue().strip().splitlines()[:8]:
            print(f"cli cluster: {line}", flush=True)
        check(r.x.is_cuda and bool(torch.isfinite(r.x).all())
              and r.iters == c["cli_iters"]
              and f"iterations: {c['cli_iters']}" in buf.getvalue(),
              f"cli --executor cluster --workers 2 at "
              f"{c['cli_nodes'] * c['cli_rows']} rows "
              f"({time.perf_counter() - t0:.1f} s) and obs_report on it")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"cluster phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


# K4's tensor-core kernel against the plain version with P rounded to bf16
# as the kernel rounds it: what is left is the output's own bf16 rounding
# (one ulp, at most 2^-7 |o|, where the two f32 results straddle a rounding
# boundary) and f32 sums in another order, which can move a rounded p by one
# ulp. Against the f32-P plain version the bound stays the reference's 2e-2.
TC_ULPS = 2.0 ** -7
TC_ABS = 2e-3


def tc_err(torch, got, want) -> float:
    """max over elements of |got - want| - 2^-7 |want|: what the kernel's
    output is off by beyond one bf16 ulp of the bf16-P plain version."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - TC_ULPS * want.abs()).max())


def route_counts(wrapper):
    """A two-kernel wrapper's per-route launch counts (K3: ring, wide; K4:
    tc, fma), or None for a one-kernel wrapper."""
    routes = {k[len("launches_"):]: v for k, v in vars(wrapper).items()
              if k.startswith("launches_")}
    return routes or None


def zero_counts(wrapper):
    wrapper.launches = 0
    for r in route_counts(wrapper) or ():
        setattr(wrapper, f"launches_{r}", 0)


def phase_attn_kernels(torch):
    """K4 against its plain version at small shapes: f32 and bf16, causal
    and not, GQA groups 1, 2 and 4, head dims 8, 16, 64 and 128, ragged
    lengths with Sq = Skv and Sq < Skv, and the model's (B, S, H, D)
    layout; each call's route (tensor cores for bf16 at D 64 / 128, FMA
    otherwise) checked by the counters; the tensor-core cases also against
    the plain version with P rounded to bf16;
    ``scaled_dot_product_attention`` printed as a second opinion."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    fa = attn_ops.flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(2, 2 * grp, 2, 256, 256, D, dt, causal, False)
             for dt in (f32, bf16) for causal in (True, False)
             for grp in (1, 2, 4) for D in (64, 128)]
    cases += [(1, 8, 2, 1000, 1000, 128, dt, True, False) for dt in (f32, bf16)]
    cases += [(2, 4, 1, 300, 1000, D, dt, c, False) for c in (True, False)
              for D, dt in ((64, f32), (64, bf16), (128, bf16))]
    # head dim 8 (the arctic-480b and command-r-35b smoke configs): FMA
    cases += [(2, 8, 2, 256, 256, 8, dt, causal, False)
              for dt in (f32, bf16) for causal in (True, False)]
    cases += [(1, 8, 8, 77, 130, 8, bf16, False, True),
              (2, 8, 2, 300, 300, 8, f32, True, True)]
    cases += [(2, 4, 2, 77, 77, 16, bf16, True, False),
              (2, 32, 16, 300, 300, 128, bf16, True, True),
              # bf16 at D 64: ragged Skv, and the model's layout
              (1, 4, 2, 200, 333, 64, bf16, False, False),
              (1, 4, 2, 333, 333, 64, bf16, True, False),
              (2, 8, 4, 300, 300, 64, bf16, True, True)]
    for B, Hq, Hkv, Sq, Skv, D, dt, causal, bshd in cases:
        def make(H, S):
            if bshd:
                return torch.randn((B, S, H, D), generator=g,
                                   device=dev).to(dt).transpose(1, 2)
            return torch.randn((B, H, S, D), generator=g, device=dev).to(dt)
        q, k, v = make(Hq, Sq), make(Hkv, Skv), make(Hkv, Skv)
        kernel = attn_ops.route(dt, D)
        before = route_counts(fa)
        o1 = fa(q, k, v, causal=causal)
        o2 = fa(q, k, v, causal=causal)
        after = route_counts(fa)
        p = attn_ops.flash_attention_plain(q, k, v, causal=causal)
        lib = sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        torch.cuda.synchronize()
        err = float((o1.float() - p.float()).abs().max())
        e_lib = float((lib.float() - p.float()).abs().max())
        tol = 2e-5 if dt == f32 else 2e-2
        name = (f"K4 flash_attention [{kernel}] B={B} Hq={Hq} Hkv={Hkv} "
                f"Sq={Sq} Skv={Skv} D={D} {str(dt)[6:]} "
                f"{'causal' if causal else 'full'}{' bshd' if bshd else ''}")
        routed = all(after[r] - before[r] == (2 if r == kernel else 0)
                     for r in after)
        check(err <= tol and torch.equal(o1, o2) and o1.dtype == dt
              and o1.shape == q.shape and routed,
              f"{name}: err {err:.2e} <= {tol:g}, bitwise repeat, routed "
              f"to {kernel} (sdpa vs plain {e_lib:.2e})")
        if kernel == "tc":
            pb = attn_ops.flash_attention_plain(q, k, v, causal=causal,
                                                p_dtype=bf16)
            e_b = float((o1.float() - pb.float()).abs().max())
            e_t = tc_err(torch, o1, pb)
            check(e_t <= TC_ABS,
                  f"{name}: vs the bf16-P plain version max err {e_b:.2e}; "
                  f"beyond one output ulp (2^-7 |o|) {e_t:.2e} <= "
                  f"{TC_ABS:g}")


def phase_wkv_kernels(torch):
    """K5 against its plain version at small shapes: head dims 16, 32 and
    64, chunks 1, 4, 8, 16 and 17 (T of one chunk among them), f32 and
    bf16 r/k/v, (B, H, T, hd) tensors, the model's (B, T, H, hd) layout
    viewed as (B, H, T, hd) and views off 16-byte alignment, the final
    state of every case, the hard-decay case (w_log = -50, clamped to -5)
    and a long sweep; every call twice, bit for bit."""
    from repro_torch.kernels.wkv import ops as wkv_ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, H, T, hd, chunk, r/k/v type, model layout, log-decay): "data" is
    # -exp(N(-2, 1)), the reference test's realistic decay; "hard" is -50
    cases = [(2, 3, 96, hd, L, dt, bthd, "data")
             for hd in (16, 32, 64) for L in (4, 8, 16) for dt in (f32, bf16)
             for bthd in (False, True)]
    # "offset": views one element into a (B, T, H, hd + 1) tensor, off
    # 16-byte alignment, which the kernel stages by plain loads
    cases += [(2, 3, 96, 64, 16, dt, "offset", "data") for dt in (f32, bf16)]
    cases += [(1, 2, 64, 64, 16, f32, False, "hard"),
              (1, 2, 64, 16, 8, bf16, True, "hard"),
              (2, 4, 1024, 64, 16, bf16, True, "data"),
              (1, 2, 136, 32, 17, f32, True, "hard"),
              # chunk 1, and T of one chunk
              (2, 3, 24, 64, 1, bf16, True, "data"),
              (1, 2, 40, 32, 1, f32, False, "hard"),
              (2, 3, 16, 64, 16, bf16, True, "data"),
              (1, 2, 17, 64, 17, f32, False, "hard")]
    for B, H, T, hd, L, dt, bthd, decay in cases:
        def make(scale, dtype=f32):
            if bthd == "offset":
                t = torch.randn((B, T, H, hd + 1), generator=g, device=dev)
                return (scale * t).to(dtype)[..., 1:].transpose(1, 2)
            if bthd:
                t = torch.randn((B, T, H, hd), generator=g,
                                device=dev).transpose(1, 2)
            else:
                t = torch.randn((B, H, T, hd), generator=g, device=dev)
            return (scale * t).to(dtype)
        r, k, v = (make(0.5, dt) for _ in range(3))
        w_log = -torch.exp(make(1.0) - 2.0) if decay == "data" \
            else make(0.0) - 50.0
        u = 0.3 * torch.randn((H, hd), generator=g, device=dev)
        y1, S1 = wkv_ops.wkv(r, k, v, w_log, u, chunk=L, return_state=True)
        y2, S2 = wkv_ops.wkv(r, k, v, w_log, u, chunk=L, return_state=True)
        yp, Sp = wkv_ops.wkv_plain(r, k, v, w_log, u, chunk=L)
        torch.cuda.synchronize()
        err = max(rel_err(torch, y1, yp), rel_err(torch, S1, Sp))
        check(err <= 2e-5 and torch.equal(y1, y2) and torch.equal(S1, S2)
              and y1.dtype == f32 and y1.shape == r.shape
              and y1.stride() == torch.empty_like(r, dtype=f32).stride()
              and bool(torch.isfinite(y1).all()),
              f"K5 wkv B={B} H={H} T={T} hd={hd} chunk={L} {str(dt)[6:]}"
              f"{'' if not bthd else ' bthd' if bthd is True else ' offset'} "
              f"{decay} decay: y and S rel err "
              f"{err:.2e} <= 2e-5, bitwise repeat, finite, y in r's layout")


def lm_inputs(torch, params, cfg, g, B, S, n_long):
    """One LM's inputs over n_long positions, drawn from the seed: (forward
    kwargs over n_long positions, the same over the first S, labels (B, S),
    tokens (B, n_long)). Text families take tokens. The encoder-decoder
    adds stub frames (B, S, d) x 0.02, its serve CLI's stub. The VLM takes
    stub patch embeddings (unit variance, as the token embeddings) at the
    3-stream M-RoPE positions of a t x h x w grid for the first S positions
    (``mrope_grid``), then text tokens at positions S, S + 1, ... on all
    three streams, which is what decode_step gives them."""
    from repro_torch.models.model import embed_tokens
    dev = torch.device("cuda")
    V = cfg.vocab_size
    tokens = torch.randint(0, V, (B, n_long), generator=g, device=dev)
    labels = torch.randint(0, V, (B, S), generator=g, device=dev)
    long, short = {"tokens": tokens}, {"tokens": tokens[:, :S]}
    if cfg.encoder_layers:
        enc = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
        long["enc_embeds"] = short["enc_embeds"] = 0.02 * enc
    if cfg.mrope:
        stub = torch.randn((B, S, cfg.d_model), generator=g,
                           device=dev).to(cfg.compute_dtype)
        text = torch.arange(S, n_long, device=dev).expand(3, n_long - S)
        pos = torch.cat([mrope_grid(torch, S, dev), text], dim=1)
        pos = pos[:, None].expand(3, B, n_long)
        long = {"embeds": torch.cat(
                    [stub, embed_tokens(params, cfg, tokens[:, S:])], dim=1),
                "positions": pos}
        short = {"embeds": stub, "positions": pos[..., :S]}
    return long, short, labels, tokens


def mrope_grid(torch, S, dev):
    """(3, S) temporal / height / width positions of S patches laid out as
    t frames of an h x h grid (h = sqrt(S / 4): 4 x 32 x 32 at S = 4096),
    so that the three M-RoPE sections take different angles."""
    h = int(round((S // 4) ** 0.5))
    t = S // (h * h)
    if t * h * h != S:
        fail(f"mrope_grid: {S} patches are no t x {h} x {h} grid")
    i = torch.arange(S, device=dev)
    return torch.stack([i // (h * h), i // h % h, i % h])


def serve_parity(torch, params, cfg, short, tokens, S, n_dec, h_full,
                 cache_dtype):
    """Prefill on the first S positions (``short``) and n_dec decode steps
    on tokens[:, S:] against the logits of the full forward's hidden states
    at the same positions: (max abs difference, max |logit|)."""
    from repro_torch.models.decode import decode_step, prefill
    want = h_full[:, S - 1:S + n_dec].float() @ params["lm_head"].float()
    lg, caches = prefill(params, cfg, s_max=S + n_dec,
                         cache_dtype=cache_dtype, **short)
    got = [lg]
    for t in range(S, S + n_dec):
        lg, caches = decode_step(params, cfg, caches, tokens=tokens[:, t],
                                 pos=t)
        got.append(lg)
    got = torch.stack(got, dim=1)
    return float((got - want).abs().max()), float(want.abs().max())


def lm_kernel(arch: str):
    """(name of the kernel, its wrapper, the keyword of forward / loss_fn
    that picks the path) of an LM slice."""
    if LM[arch]["kernel"] == "K4_flash_attention":
        from repro_torch.kernels.flash_attn import ops as attn_ops
        return "K4_flash_attention", attn_ops.flash_attention, "attn_impl"
    from repro_torch.kernels.wkv import ops as wkv_ops
    return "K5_wkv", wkv_ops.wkv, "wkv_impl"


def launches_per_forward(cfg, kname: str) -> int:
    """The kernel's launches in one ``forward``: K5 once a rwkv layer; K4
    once a layer whose attention has no window (attn, moe, cross; griffin's
    attn_local takes the chunked path, as in the reference), once more for
    each cross attention, and once an encoder layer."""
    from repro_torch.models.model import layer_kinds
    kinds = layer_kinds(cfg)
    if kname == "K5_wkv":
        return kinds.count("rwkv")
    return sum(k in ("attn", "moe", "cross") for k in kinds) \
        + kinds.count("cross") + cfg.encoder_layers


def extra_params(cfg) -> int:
    """What ``param_count()`` leaves out of the parameter tree."""
    from repro_torch.models.model import layer_kinds
    d, L, hd = cfg.d_model, cfg.num_layers, cfg.head_dim
    if cfg.family == "rwkv6":
        # channel mix's receptance (d^2), the decay LoRA (4 d r), the
        # vectors beyond two norms (maa_base 5d, decay_base, bonus, gn
        # scale and bias, mu_k, mu_r: 11 d), the final norm
        return L * (d * d + 4 * d * cfg.rwkv_lora_rank + 11 * d) + d
    kinds = layer_kinds(cfg)
    # each attention module's kv_repeat widening of wk / wv and its
    # qk-norm scales (cross attention and the encoder's included), the
    # final norm and the encoder's
    n_att = sum(k != "rec" for k in kinds) + kinds.count("cross") \
        + cfg.encoder_layers
    extra = n_att * (2 * d * hd * (cfg.kv_heads_eff - cfg.num_kv_heads)
                     + 2 * hd * cfg.qk_norm) + d + d * bool(cfg.encoder_layers)
    if cfg.family == "griffin":
        # param_count() counts every layer as a recurrent block without
        # its (lw, lw) gates w_a, w_i; attn_local layers hold attention
        lw, H = cfg.lru_width, cfg.num_heads
        rec = 3 * d * lw + lw * cfg.conv_width + 2 * lw
        att = 2 * d * H * hd + 2 * d * cfg.num_kv_heads * hd
        n_rec = kinds.count("rec")
        extra += n_rec * 2 * lw * lw + kinds.count("attn_local") * (att - rec)
    return extra


def nudged(torch, emb, share):
    """``emb`` with a ``share`` of its elements (drawn from the seed)
    multiplied by 1 + 2^-7: moved by one or two bf16 ulps, the size of a
    rounding that two orders of summation can disagree on."""
    g = torch.Generator(device=emb.device).manual_seed(SEED + 5)
    moved = torch.rand(emb.shape, generator=g, device=emb.device) < share
    return torch.where(moved, (emb.float() * (1 + 2 ** -7)).to(emb.dtype),
                       emb)


def nudged_inputs(torch, params, cfg, inputs, share):
    """``inputs`` with their decoder embeddings nudged (``nudged``)."""
    from repro_torch.models.model import embed_tokens
    out = {k: v for k, v in inputs.items() if k != "tokens"}
    emb = inputs["embeds"] if "embeds" in inputs \
        else embed_tokens(params, cfg, inputs["tokens"])
    out["embeds"] = nudged(torch, emb, share)
    return out


def rel_diffs(torch, got, want):
    """(max |got - want| / max |want|, mean |got - want| / mean |want|)."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    return float(d.max() / w.max()), float(d.mean() / w.mean())


def drop_share(stats, routed=None) -> float:
    """The share of routed (token, expert) pairs that capacity dropped, over
    the ``moe.DROP_STATS`` entries (of ``routed`` pairs a call, if given)."""
    rows = [(int(k), r) for k, r in stats if routed in (None, r)]
    total = sum(r for _, r in rows)
    return 1.0 - sum(k for k, _ in rows) / max(total, 1)


@contextlib.contextmanager
def moe_routes(torch, record=None, replay=None):
    """Within it, each ``moe.route_topk`` call appends its (T, k) experts
    to ``record``; with ``replay`` (a list that ``record`` filled on a
    forward of the same shapes) each call takes the matching call's
    experts in place of its own top-k, weighted by its own renormalised
    probabilities. A forward that replays its own routes is unchanged, bit
    for bit."""
    from repro_torch.models import moe as moe_lib
    own = moe_lib.route_topk
    calls = None if replay is None else iter(replay)

    def route(logits, k):
        w, i, aux = own(logits, k)
        if calls is not None:
            i = next(calls)
            p = torch.softmax(logits, dim=-1).gather(1, i)
            w = p / p.sum(dim=-1, keepdim=True)
        if record is not None:
            record.append(i.contiguous())
        return w, i, aux

    moe_lib.route_topk = route
    try:
        yield
    finally:
        moe_lib.route_topk = own


def flips(torch, ra, rb, B, S):
    """Two forwards' routes (``moe_routes`` records), compared over the
    first S tokens of each of B rows: (the share of tokens sent to another
    set of experts in some layer, the share of (token, layer) pairs)."""
    any_layer, pairs = torch.zeros((B, S), dtype=torch.bool,
                                   device=ra[0].device), 0.0
    for a, b in zip(ra, rb, strict=True):
        a, b = (r.reshape(B, -1, r.shape[-1])[:, :S].sort(dim=-1).values
                for r in (a, b))
        moved = (a != b).any(dim=-1)
        any_layer |= moved
        pairs += float(moved.float().mean())
    return float(any_layer.float().mean()), pairs / len(ra)


def parity_capacity(cfg) -> float:
    """The capacity factor of the runs that hold prefill + decode to
    forward: 8 for MoE, where nothing drops (decode routes B tokens a step,
    whose capacity drops pairs the forward keeps; the reference's
    tests/test_decode_parity.py runs MoE at 8 too), else the config's."""
    return 8.0 if cfg.family == "moe" else cfg.capacity_factor


def lm_config(arch, sh, smoke: bool):
    """The arch's config (smoke or full), its depth cut to ``sh["layers"]``."""
    import repro_torch.configs as configs
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if sh.get("layers"):    # depth cut to fit the card
        cfg = dataclasses.replace(cfg, num_layers=sh["layers"])
    return cfg


def phase_lm(torch, rt, arch, sh, smoke: bool):
    from repro_torch.kernels.flash_attn.ops import route
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import forward, init_params, loss_fn, \
        tree_map

    spec = LM[arch]
    kname, wrapper, impl_kw = lm_kernel(arch)
    xla = {impl_kw: "xla"}
    dev = torch.device("cuda")
    cfg = lm_config(arch, sh, smoke)
    g = torch.Generator(device=dev).manual_seed(SEED)
    B, S, n_dec = sh["batch"], sh["seq"], sh["decode"]
    # the long forward covers the decode positions; an rwkv forward takes
    # whole chunks only
    step = cfg.wkv_chunk if cfg.family == "rwkv6" else 1
    n_long = S + -(-n_dec // step) * step
    V = cfg.vocab_size
    moe = cfg.family == "moe"
    t0 = time.perf_counter()
    params = init_params(cfg, g)
    torch.cuda.synchronize()
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    n_par = sum(sizes)
    extra = extra_params(cfg)
    print(f"lm: {cfg.name}, {cfg.num_layers} layers"
          f"{f' (+ {cfg.encoder_layers} encoder)' if cfg.encoder_layers else ''}"
          f", d {cfg.d_model}, {cfg.num_heads} heads, vocab {V}: {n_par} "
          f"parameters f32 ({n_par * 4 / 1e9:.1f} GB) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    check(n_par == cfg.param_count() + extra,
          f"lm: parameter count {n_par} = param_count() + {extra} (what "
          "the formula leaves out)")
    long, short, labels, tokens = lm_inputs(torch, params, cfg, g, B, S,
                                            n_long)
    per_fwd = launches_per_forward(cfg, kname)

    with torch.inference_mode():
        # the main path: counts set to 0 just before and read just after
        zero_counts(wrapper)
        moe_lib.DROP_STATS = [] if moe else None
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h_k, _ = forward(params, cfg, **short)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        stats, moe_lib.DROP_STATS = moe_lib.DROP_STATS, None
        t0 = time.perf_counter()
        loss, met = loss_fn(params, cfg, {**short, "labels": labels})
        loss = float(loss)
        t_loss = time.perf_counter() - t0
        h_long, _ = forward(params, cfg, **long)
        torch.cuda.synchronize()
        launches = wrapper.launches
        routes = route_counts(wrapper)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(launches == 3 * per_fwd,
              f"lm main path: {kname} launched {launches} times = "
              f"{per_fwd} a forward x 3 forwards")
        if routes is not None:
            # bf16 at head dims 64 / 128: every launch on the tensor-core
            # kernel (the smoke configs' head dims 8 and 16: FMA)
            want = route(cfg.compute_dtype, cfg.head_dim)
            check(routes == {r: launches * (r == want) for r in routes},
                  f"lm main path: {kname} routes {routes}: all "
                  f"{launches} on the {want} kernel")
        rt["launches"][spec.get("record", kname)] = launches
        print(f"lm forward {B}x{S}: {t_fwd:.3f} s "
              f"({B * S / t_fwd:.0f} tok/s); loss_fn {t_loss:.3f} s; "
              f"peak device memory {peak:.2f} GB", flush=True)
        if moe:
            print(f"lm: MoE capacity factor {cfg.capacity_factor}: "
                  f"{drop_share(stats):.4f} of the {B * S} x "
                  f"{cfg.experts_per_token} (token, expert) pairs dropped in "
                  f"forward, over {len(stats)} layers", flush=True)
            r_k = []
            with moe_routes(torch, record=r_k):
                h_again, _ = forward(params, cfg, **short)
            check(torch.equal(h_again, h_k),
                  "lm: a second forward gives bit-identical hidden states "
                  "(the MoE combine has no atomics)")
            with moe_routes(torch, replay=r_k):
                h_again, _ = forward(params, cfg, **short)
            check(torch.equal(h_again, h_k),
                  "lm: a forward that replays its own expert choices gives "
                  "bit-identical hidden states (routing can be pinned)")
            del h_again
        check(h_k.shape == (B, S, cfg.d_model) and h_k.dtype == torch.bfloat16
              and bool(torch.isfinite(h_k).all()),
              f"lm: hidden states finite, ({B}, {S}, {cfg.d_model}) bf16")

        # bf16 compute: each layer rounds its mixer's output to bf16, so
        # the two paths first differ by an occasional bf16 ulp (2^-8
        # relative), and random layers amplify that everywhere. qwen3-8b
        # reaches a few percent (3.4e-2 max, 2.1e-2 mean on one H100) and
        # is held to fixed bounds, as are the dense-like families. rwkv6-
        # 1.6b grows it to 1e-1 - 2e-1 over 24 layers, from ~1e-5 (mean)
        # within one layer. The same forward grows a one-or-two-ulp change
        # of 0.1 % of its input elements just as far (PERF.md). So rwkv6
        # and MoE are held to that control: the kernel may change the
        # result no more than such a change of the input does. The kernel
        # itself is held tightly by the f32 run below and the kernel
        # phases. MoE turns a small difference into another expert for a
        # token whose k-th and (k+1)-th router probabilities are that
        # close, and such a token moves by O(1) whichever perturbation
        # made it change: the largest element of either difference is a
        # routing flip's and says nothing of the kernel, so there the
        # control holds the mean (how many tokens moved) and the max is
        # printed with the share of tokens that changed experts. Then
        # both paths run again with the experts pinned to the kernel
        # path's choices (``moe_routes``): no token can flip, and the
        # difference, the kernel's alone, is held to the dense families'
        # fixed bounds.
        control = spec["bf16_control"]
        h_c = None
        if control:
            r_c, r_l = [], []
            with moe_routes(torch, record=r_c):
                h_c, _ = forward(params, cfg, **nudged_inputs(
                    torch, params, cfg, long, control))
            if moe:     # h_long's routes
                with moe_routes(torch, record=r_l):
                    forward(params, cfg, **long)
            b_max, b_mean = rel_diffs(torch, h_c[:, :S], h_long[:, :S])
            what = f"the nudged-input control, {control:.1%} of the inputs"
        else:
            b_max, b_mean = 1e-1, 5e-2
            what = "fixed"
        if per_fwd:
            r_x = []
            t0 = time.perf_counter()
            with moe_routes(torch, record=r_x):
                h_x, _ = forward(params, cfg, **short, **xla)
            torch.cuda.synchronize()
            print(f"lm forward {B}x{S}, {impl_kw}='xla' (chunked): "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            e_max, e_mean = rel_diffs(torch, h_k, h_x)
            head = (f"lm: {kname} vs chunked hidden states, bf16, "
                    f"{cfg.num_layers} layers")
            if moe:
                f_e, p_e = flips(torch, r_x, r_k, B, S)
                f_c, p_c = flips(torch, r_c, r_l, B, S)
                check(e_mean <= b_mean,
                      f"{head}: mean |dh| / mean |h| {e_mean:.2e} <= "
                      f"{b_mean:.2e} ({what}); not held: max |dh| / max "
                      f"|h| {e_max:.2e} (control {b_max:.2e}), tokens that "
                      f"changed experts in some layer {f_e:.2%} (control "
                      f"{f_c:.2%}), (token, layer) pairs {p_e:.2%} (control "
                      f"{p_c:.2%})")
                with moe_routes(torch, replay=r_k):
                    h_x, _ = forward(params, cfg, **short, **xla)
                e_max, e_mean = rel_diffs(torch, h_k, h_x)
                del r_k, r_x, r_c, r_l
                head += ", experts pinned to the kernel path's"
                p_max, p_mean, p_what = 1e-1, 5e-2, "fixed"
            else:
                p_max, p_mean, p_what = b_max, b_mean, what
            del h_x
            check(e_max <= p_max and e_mean <= p_mean,
                  f"{head}: max |dh| / max |h| {e_max:.2e} <= {p_max:.2e}, "
                  f"mean |dh| / mean |h| {e_mean:.2e} <= {p_mean:.2e} "
                  f"({p_what})")
        else:
            print(f"lm: {kname} is not on {cfg.name}'s path (0 launches "
                  "checked): no kernel-against-chunked comparison",
                  flush=True)
        ln_v = math.log(V)
        # random weights and labels: ce = ln V + var(logit) / 2, logits
        # of unit variance, plus a 1e-4 z-loss (and the router aux loss)
        check(math.isfinite(loss) and abs(loss - ln_v) <= 1.5,
              f"lm: loss_fn {loss:.4f} (ce {float(met['ce']):.4f}, aux "
              f"{float(met['aux']):.4f}) within 1.5 of ln V = {ln_v:.2f}")
        if not moe:
            err, top = serve_parity(torch, params, cfg, short, tokens, S,
                                    n_dec, h_long, torch.bfloat16)
            if control:
                b_err = float(((h_c[:, S - 1:S + n_dec].float()
                                - h_long[:, S - 1:S + n_dec].float())
                               @ params["lm_head"].float()).abs().max())
            else:
                b_err = 5e-2 * top
            check(err <= b_err,
                  f"lm: prefill {B}x{S} + {n_dec} decode steps, bf16 caches, "
                  f"vs forward logits: max err {err:.3e} <= {b_err:.3e} "
                  f"({what}; max |logit| {top:.3f})")
        else:
            # MoE: decode routes B tokens at a time, whose capacity (1 slot
            # an expert at 1.25) drops pairs the forward keeps; the f32 run
            # below checks serving at a capacity where nothing drops
            print(f"lm: bf16 serving parity left to the f32 run "
                  f"(capacity {parity_capacity(cfg)})", flush=True)
    del params, h_k, h_long, h_c, long, short
    print(f"lm: freed, {free_device_memory(torch):.2f} GB still allocated",
          flush=True)

    # full width, f32 compute, a few layers: tight bounds. MoE runs at a
    # capacity where nothing drops, so that serving (B tokens a decode
    # step) and forward route alike.
    n32 = sh["f32_layers"]
    cfg = dataclasses.replace(
        cfg, num_layers=n32, compute_dtype=torch.float32,
        encoder_layers=min(cfg.encoder_layers, n32),
        capacity_factor=parity_capacity(cfg))
    params = init_params(cfg, g)
    long, short, _, tokens = lm_inputs(torch, params, cfg, g, B, S, n_long)
    per_fwd = launches_per_forward(cfg, kname)
    with torch.inference_mode():
        before, routes = wrapper.launches, route_counts(wrapper)
        h_k, _ = forward(params, cfg, **long)
        h_x, _ = forward(params, cfg, **long, **xla)
        torch.cuda.synchronize()
        check(wrapper.launches - before == per_fwd,
              f"lm f32 {cfg.num_layers} layers: {kname} launched "
              f"{wrapper.launches - before} = {per_fwd} times a forward")
        if routes is not None:
            moved = {r: n - routes[r] for r, n in
                     route_counts(wrapper).items()}
            want = route(cfg.compute_dtype, cfg.head_dim)
            check(want == "fma" and moved == {
                      r: per_fwd * (r == want) for r in moved},
                  f"lm f32 {cfg.num_layers} layers: {kname} routes "
                  f"{moved}: all on the FMA kernel")
        e = float((h_k - h_x).abs().max() / h_x.abs().max())
        check(bool(torch.isfinite(h_k).all()) and e <= 1e-4,
              f"lm f32 {cfg.num_layers} layers, {B}x{n_long}: {kname} vs "
              f"chunked hidden states max |dh| / max |h| {e:.2e} <= 1e-4")
        err, top = serve_parity(torch, params, cfg, short, tokens, S, n_dec,
                                h_k, torch.float32)
        check(err <= 2e-4 * top,
              f"lm f32 {cfg.num_layers} layers: prefill + {n_dec} decode "
              f"steps, f32 caches, vs forward logits: max err {err:.3e} <= "
              f"2e-4 x max |logit| {top:.3f}")
    del params, h_k, h_x, long, short
    free_device_memory(torch)


def phase_serve(torch, rt, arch, sh, smoke: bool):
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import layer_kinds

    kname, wrapper, _ = lm_kernel(arch)
    cfg = lm_config(arch, sh, smoke)
    B, prompt, n = sh["serve"]
    args = ["--arch", arch, "--batch", str(B), "--prompt-len", str(prompt),
            "--gen", str(n), "--seed", str(SEED)] + (["--smoke"] * smoke)
    if sh.get("layers"):
        args += ["--layers", str(sh["layers"])]
    moe = cfg.family == "moe"
    moe_lib.DROP_STATS = [] if moe else None
    before = wrapper.launches
    t0 = time.perf_counter()
    print(f"serve: {' '.join(args)}", flush=True)
    gen = serve.main(args)
    secs = time.perf_counter() - t0
    stats, moe_lib.DROP_STATS = moe_lib.DROP_STATS, None
    check(gen.shape == (B, n) and int(gen.min()) >= 0
          and int(gen.max()) < cfg.vocab_size,
          f"serve: ({B}, {n}) generated tokens in the vocabulary, "
          f"{secs:.1f} s with weight init")
    # attention: prefill runs the decoder's chunked path and decode the
    # einsum step, as the reference does, so K4 is on it only in the
    # encoder of an encoder-decoder (once an encoder layer); rwkv: prefill
    # runs K5 in every layer, decode the per-step recurrence
    want = layer_kinds(cfg).count("rwkv") if kname == "K5_wkv" \
        else cfg.encoder_layers
    check(wrapper.launches - before == want,
          f"serve: {kname} launched {wrapper.launches - before} times = "
          f"{want} (prefill)")
    n_par = cfg.param_count() + extra_params(cfg)
    floor = n_par * 4 / rt["peaks"][0] * 1e3
    print(f"serve: decode weight-read floor {floor:.2f} ms/step (f32 weights "
          f"{n_par * 4 / 1e9:.1f} GB over {rt['peaks'][0] / 1e12:.2f} TB/s)",
          flush=True)
    if moe:
        k = cfg.experts_per_token
        print(f"serve: MoE capacity factor {cfg.capacity_factor}: dropped "
              f"{drop_share(stats, B * prompt * k):.4f} of the pairs in "
              f"prefill ({B}x{prompt} tokens a layer), "
              f"{drop_share(stats, B * k):.4f} in decode ({B} tokens a "
              "layer and step)", flush=True)
    del gen
    free_device_memory(torch)


def time_k4(torch, rt, reps, name, B, Hq, Hkv, S, D, causal,
            plain_reps=3):
    """K4 at one of the main path's shapes, bf16 in the model's (B, S, H,
    D) layout: against its plain version (and, on the tensor-core route,
    the plain version with P rounded to bf16) and
    ``scaled_dot_product_attention``, bitwise repeat; the record ``name``.
    Returns (q, k, v, kernel ms, operations)."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)

    def make(H):   # the model's layout: a (B, S, H, D) projection, viewed
        return torch.randn((B, S, H, D), generator=g,
                           device=dev).to(torch.bfloat16).transpose(1, 2)

    q, k, v = make(Hq), make(Hkv), make(Hkv)
    kern = lambda: attn_ops.flash_attention(q, k, v, causal=causal)
    plain = lambda: attn_ops.flash_attention_plain(q, k, v, causal=causal)
    lib = lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    o, p, yard = kern(), plain(), lib()
    tc = attn_ops.route(q.dtype, D) == "tc"
    e_t = 0.0
    if tc:
        pb = attn_ops.flash_attention_plain(q, k, v, causal=causal,
                                            p_dtype=torch.bfloat16)
        e_t = tc_err(torch, o, pb)
        del pb
    err = float((o.float() - p.float()).abs().max())
    e_lib = float((yard.float() - p.float()).abs().max())
    check(err <= 2e-2 and e_t <= TC_ABS and torch.equal(o, kern()),
          f"K4 at B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} bf16 "
          f"{'causal' if causal else 'full'} [{'tc' if tc else 'fma'}]: err "
          f"{err:.2e} <= 2e-2, vs bf16-P plain beyond one output ulp "
          f"{e_t:.2e} <= {TC_ABS:g}, bitwise repeat (sdpa vs plain "
          f"{e_lib:.2e})")
    del o, p, yard
    pairs = S * (S + 1) // 2 if causal else S * S
    nflops = 4 * D * B * Hq * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    timer = Timer(torch, reps)
    k_ms = timer(kern)
    # the bound takes the peak of the operands' type (bf16), whichever
    # route runs them: the FMA kernel's FP32 units do not lower it
    record(rt, name, err, k_ms, Timer(torch, plain_reps)(plain),
           bound(rt, nbytes, nflops, peak="bf16"), timer(lib))
    print(f"{name} work: {nflops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; "
          f"{nflops / k_ms / 1e9:.2f} TFLOP/s achieved", flush=True)
    return q, k, v, k_ms, nflops


def phase_attn_timing(torch, rt, reps: int, arch, sh, smoke: bool):
    """K4 at the qwen lm shape, then its FMA route on f32 copies of the
    same inputs (printed)."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    cfg = lm_config(arch, sh, smoke)
    B, S, D = sh["batch"], sh["seq"], cfg.head_dim
    q, k, v, k_ms, nflops = time_k4(torch, rt, reps, "K4_flash_attention", B,
                                    cfg.num_heads, cfg.kv_heads_eff, S, D,
                                    True, plain_reps=reps)
    print(f"K4: bound at the FP32 peak {nflops / rt['peaks'][1] * 1e3:.3f} "
          "ms", flush=True)
    # the FMA route on f32 copies of the same inputs (same layout)
    qf, kf, vf = q.float(), k.float(), v.float()
    fma = lambda: attn_ops.flash_attention(qf, kf, vf, causal=True)
    before = attn_ops.flash_attention.launches_fma
    of = fma()
    pf = attn_ops.flash_attention_plain(qf, kf, vf, causal=True)
    e_f = float((of - pf).abs().max())
    check(attn_ops.flash_attention.launches_fma == before + 1
          and e_f <= 1e-4,
          f"K4 FMA route at the same shape, f32: err {e_f:.2e} <= 1e-4")
    del of, pf
    f_ms = Timer(torch, reps)(fma)
    print(f"time K4 FMA route (flash_attn.cu), f32 inputs: {f_ms:.3f} ms, "
          f"{nflops / f_ms / 1e9:.2f} TFLOP/s; bound at the FP32 peak "
          f"{nflops / rt['peaks'][1] * 1e3:.3f} ms", flush=True)


def phase_k4_timing(torch, rt, reps: int, arch, sh, smoke: bool):
    """K4 at an LM's main-path shape (the encoder-decoder's: full, the
    encoder's and the cross attention's, with S_enc = S), record
    ``LM[arch]["record"]``."""
    cfg = lm_config(arch, sh, smoke)
    time_k4(torch, rt, reps, LM[arch]["record"], sh["batch"],
            cfg.num_heads, cfg.kv_heads_eff, sh["seq"], cfg.head_dim,
            not cfg.encoder_layers)
    free_device_memory(torch)


def phase_moe_timing(torch, rt, reps: int, arch, sh, smoke: bool):
    """K4 at olmoe's shape, then one MoE FFN at the forward's shape (B x S
    tokens, bf16, capacity 1.25): ``moe_ffn`` against its three expert
    products alone (the rest is routing, dispatch and combine), and
    against itself bit for bit."""
    from repro_torch.models import moe as moe_lib
    phase_k4_timing(torch, rt, reps, arch, sh, smoke)
    cfg = lm_config(arch, sh, smoke)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    p = moe_lib.init_moe(g, cfg)
    B, S = sh["batch"], sh["seq"]
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    C = moe_lib.capacity(cfg, B * S)
    x = torch.randn((B, S, d), generator=g, device=dev).bfloat16()
    xe = torch.randn((E, C, d), generator=g, device=dev).bfloat16()
    with torch.inference_mode():
        full = lambda: moe_lib.moe_ffn(p, cfg, x)[0]
        check(torch.equal(full(), full()),
              f"moe_ffn at {B}x{S} tokens: bit-identical repeat")

        def experts():
            h = torch.nn.functional.silu(
                torch.bmm(xe, p["we1"].bfloat16())) \
                * torch.bmm(xe, p["we3"].bfloat16())
            return torch.bmm(h, p["we2"].bfloat16())
        timer = Timer(torch, reps)
        t_full, t_exp = timer(full), timer(experts)
    flops = 2 * 3 * E * C * d * f
    print(f"time moe_ffn at {B}x{S} tokens, E {E}, top-{cfg.experts_per_token}"
          f", C {C}, bf16: {t_full:.3f} ms; its expert products alone (with "
          f"the f32 -> bf16 weight casts) {t_exp:.3f} ms "
          f"({t_exp / t_full:.1%}; {flops / t_exp / 1e9:.1f} TFLOP/s); "
          f"routing, dispatch and combine {t_full - t_exp:.3f} ms",
          flush=True)
    del p, x, xe
    free_device_memory(torch)


def phase_scan_timing(torch, rt, reps: int, arch, sh, smoke: bool):
    """The RG-LRU's doubling scan (``griffin.scan_affine``) in f32 at
    (B, S, lru_width) against a sequential recurrence (1e-5 relative to
    max |h|); its time beside ``rg_lru``'s and the whole recurrent
    block's at the forward's shape (bf16 compute)."""
    from repro_torch.models import griffin
    cfg = lm_config(arch, sh, smoke)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    B, S, lw = sh["batch"], sh["seq"], cfg.lru_width
    # a in (0, 1) as exp(-8 softplus(0.7) r) gives it, b of unit size
    a = torch.exp(-8.0 * 1.1032 * torch.rand((B, S, lw), generator=g,
                                              device=dev))
    b = torch.randn((B, S, lw), generator=g, device=dev)
    with torch.inference_mode():
        got = griffin.scan_affine(a, b)
        h = torch.zeros((B, lw), device=dev)
        want = torch.empty_like(b)
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want[:, t] = h
        e = float((got - want).abs().max() / want.abs().max())
        check(e <= 1e-5, f"RG-LRU doubling scan at ({B}, {S}, {lw}) f32 vs "
              f"the sequential recurrence: max |dh| / max |h| {e:.2e} <= "
              "1e-5")
        p = griffin.init_recurrent_block(g, cfg)
        x = torch.randn((B, S, cfg.d_model), generator=g,
                        device=dev).to(cfg.compute_dtype)
        u = torch.randn((B, S, lw), generator=g,
                        device=dev).to(cfg.compute_dtype)
        timer = Timer(torch, reps)
        t_scan = timer(lambda: griffin.scan_affine(a, b))
        t_lru = timer(lambda: griffin.rg_lru(p, u))
        t_block = timer(lambda: griffin.recurrent_block(p, cfg, x))
    steps = math.ceil(math.log2(S))
    print(f"time RG-LRU at ({B}, {S}, {lw}): doubling scan {t_scan:.3f} ms "
          f"({steps} steps; {t_scan / t_block:.1%} of the block), rg_lru "
          f"{t_lru:.3f} ms, recurrent_block {t_block:.3f} ms; the scan's "
          f"byte floor {3 * a.numel() * 4 / rt['peaks'][0] * 1e3:.3f} ms "
          "(read a and b, write h)", flush=True)
    del a, b, got, want, p, x, u
    free_device_memory(torch)


SMOKE_ARCHS = ("arctic-480b", "qwen3-14b", "phi3-medium-14b",
               "command-r-35b")


def phase_lm_smoke_configs(torch, rt, reps: int, B=2, S=256, n_dec=4):
    """The four configs that run only at their smoke sizes here (arctic-
    480b does not fit one card; the three dense ones run qwen3-8b's path):
    forward as published (bf16; K4 counted by route: FMA, head dims 8 and
    16), then in f32 (capacity 8 for arctic's MoE, so nothing drops) the
    forward against the chunked path (1e-4) and prefill + decode against
    it (2e-4 x max |logit|). K4 at head dim 8 timed, record
    ``K4_flash_attention_d8`` (its launches: the D 8 bf16 forwards)."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.models.model import forward, init_params, loss_fn
    fa = attn_ops.flash_attention
    dev = torch.device("cuda")
    d8 = 0
    for arch in SMOKE_ARCHS:
        cfg = configs.get_smoke(arch)
        g = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, g)
        long, short, labels, tokens = lm_inputs(torch, params, cfg, g, B, S,
                                                S + n_dec)
        per = launches_per_forward(cfg, "K4_flash_attention")
        want = attn_ops.route(cfg.compute_dtype, cfg.head_dim)
        with torch.inference_mode():
            before = route_counts(fa)
            h, _ = forward(params, cfg, **short)
            torch.cuda.synchronize()
            moved = {r: n - before[r] for r, n in route_counts(fa).items()}
            loss = float(loss_fn(params, cfg, {**short, "labels": labels})[0])
            check(moved == {r: per * (r == want) for r in moved}
                  and bool(torch.isfinite(h).all())
                  and abs(loss - math.log(cfg.vocab_size)) <= 1.5,
                  f"lm smoke {arch} (head dim {cfg.head_dim}, bf16): K4 "
                  f"routes {moved} = {per} on {want}; hidden states finite; "
                  f"loss {loss:.3f} within 1.5 of ln V")
            d8 += per * (cfg.head_dim == 8)
            cfg = dataclasses.replace(
                cfg, compute_dtype=torch.float32,
                capacity_factor=parity_capacity(cfg))
            params = init_params(cfg, g)
            long, short, _, tokens = lm_inputs(torch, params, cfg, g, B, S,
                                               S + n_dec)
            before = route_counts(fa)
            h_k, _ = forward(params, cfg, **long)
            h_x, _ = forward(params, cfg, **long, attn_impl="xla")
            moved = {r: n - before[r] for r, n in route_counts(fa).items()}
            e = float((h_k - h_x).abs().max() / h_x.abs().max())
            err, top = serve_parity(torch, params, cfg, short, tokens, S,
                                    n_dec, h_k, torch.float32)
            check(moved == {r: per * (r == "fma") for r in moved}
                  and e <= 1e-4 and err <= 2e-4 * top,
                  f"lm smoke {arch} f32: K4 routes {moved}; vs chunked "
                  f"{e:.2e} <= 1e-4; prefill + {n_dec} decode steps vs "
                  f"forward {err:.3e} <= 2e-4 x {top:.3f}")
        del params, h, h_k, h_x, long, short
    rt["launches"]["K4_flash_attention_d8"] = d8
    cfg = configs.get_smoke("arctic-480b")
    time_k4(torch, rt, reps, "K4_flash_attention_d8", B, cfg.num_heads,
            cfg.kv_heads_eff, S, cfg.head_dim, True, plain_reps=reps)
    free_device_memory(torch)


def wkv_work(B, H, T, hd, L):
    """(FP32 operations, bytes) of one WKV call: the strictly lower score
    tile and its product with v, r~ S and the state update per chunk, ~9
    operations per element for the prefix sum, three exps (one each) and
    the scalings; bf16 r/k/v, f32 w_log and y, f32 u."""
    n = B * H * T * hd
    nch = B * H * (T // L)
    flops = nch * (2 * L * (L - 1) * hd + 4 * L * hd * hd + 2 * hd * hd
                   + 5 * L * hd) + 9 * n
    return flops, 3 * n * 2 + 2 * n * 4 + H * hd * 4


def phase_wkv_timing(torch, rt, reps: int, arch, sh, smoke: bool):
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.models.rwkv6 import _wkv_chunked_matmul

    cfg = lm_config(arch, sh, smoke)
    B, T = sh["batch"], sh["seq"]
    hd, L = cfg.rwkv_head_dim, cfg.wkv_chunk
    H = cfg.d_model // hd
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def make():    # the model's layout: a (B, T, H, hd) tensor, viewed
        return torch.randn((B, T, H, hd), generator=g,
                           device=dev).transpose(1, 2)

    r, k, v = (0.5 * make()).bfloat16(), (0.5 * make()).bfloat16(), \
        (0.5 * make()).bfloat16()
    w_log = torch.clamp(-torch.exp(make() - 2.0), min=-5.0)
    u = 0.3 * torch.randn((H, hd), generator=g, device=dev)
    kern = lambda: wkv_ops.wkv(r, k, v, w_log, u, chunk=L)
    plain = lambda: wkv_ops.wkv_plain(r, k, v, w_log, u, chunk=L)[0]
    # the form K5 replaces on the model's path (time_mix, wkv_impl="xla")
    form = lambda: _wkv_chunked_matmul(r.float(), k.float(), v.float(),
                                       w_log, u, L)[0]
    y, p, f = kern(), plain(), form()
    err = float((y - p).abs().max())
    e_rel = rel_err(torch, y, p)
    e_form = rel_err(torch, y, f)
    check(e_rel <= 2e-5 and e_form <= 2e-5 and torch.equal(y, kern()),
          f"K5 at B={B} H={H} T={T} hd={hd} chunk={L} bf16: rel err "
          f"{e_rel:.2e} <= 2e-5 vs plain, {e_form:.2e} <= 2e-5 vs the "
          "chunked matmul form, bitwise repeat")
    del y, p, f
    nflops, nbytes = wkv_work(B, H, T, hd, L)
    timer = Timer(torch, reps)
    k_ms = timer(kern)
    record(rt, "K5_wkv", err, k_ms, timer(plain), bound(rt, nbytes, nflops),
           None)
    f_ms = timer(form)
    print(f"K5 work: {nflops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; "
          f"{nflops / k_ms / 1e9:.2f} TFLOP/s achieved; torch "
          f"_wkv_chunked_matmul (the model's wkv_impl='xla' path) "
          f"{f_ms:.3f} ms", flush=True)
    check(k_ms < f_ms, f"K5 {k_ms:.3f} ms < _wkv_chunked_matmul "
          f"{f_ms:.3f} ms")


# arch -> its kernel, the record of its kernel's launches, its timing
# phase, the share of inputs its nudged-input control moves if its bf16
# agreement is held to that control (phase_lm), whether bf16 serving is compared with forward, the MoE
# capacity factor of its f32 serving check, and its shapes: batch x seq is
# the forward and loss shape, decode the decode steps checked, f32_layers
# the depth of the f32 run, serve = (batch, prompt length, generated
# tokens), layers a cut of depth
FULL = dict(batch=2, seq=4096, decode=4, f32_layers=4, serve=(8, 2048, 64))
# --lm-smoke: the smoke configs at toy shapes (a rehearsal)
SMOKE = dict(batch=2, seq=256, decode=4, f32_layers=2, serve=(2, 64, 8))
LM = {
    # qwen3-8b (hf:Qwen/Qwen3-8B) at full width and depth
    "qwen3-8b": dict(
        kernel="K4_flash_attention", timing=phase_attn_timing,
        bf16_control=False, shapes={"full": FULL, "smoke": SMOKE}),
    # rwkv6-1.6b (arXiv:2404.05892) at full width and depth
    "rwkv6-1.6b": dict(
        kernel="K5_wkv", timing=phase_wkv_timing, bf16_control=1e-3,
        shapes={"full": dict(FULL, batch=8), "smoke": SMOKE}),
    # olmoe-1b-7b (arXiv:2409.02060) at full width and depth: 16 layers of
    # 64 experts, top-8
    "olmoe-1b-7b": dict(
        kernel="K4_flash_attention", record="K4_flash_attention_olmoe",
        timing=phase_moe_timing, bf16_control=1e-3,
        shapes={"full": dict(FULL, f32_layers=2), "smoke": SMOKE}),
    # recurrentgemma-9b (arXiv:2402.19427) at full width and depth: 26 rec
    # + 12 attn_local layers (window 2048); K4 is not on its path
    "recurrentgemma-9b": dict(
        kernel="K4_flash_attention",
        record="K4_flash_attention_recurrentgemma",
        timing=phase_scan_timing, bf16_control=False,
        shapes={"full": dict(FULL, f32_layers=3),
                "smoke": dict(SMOKE, f32_layers=3, serve=(2, 16, 8))}),
    # seamless-m4t-large-v2 (arXiv:2308.11596) at full width and depth: 24
    # encoder + 24 decoder layers, stub frames
    "seamless-m4t-large-v2": dict(
        kernel="K4_flash_attention", record="K4_flash_attention_seamless",
        timing=phase_k4_timing, bf16_control=False,
        shapes={"full": FULL, "smoke": SMOKE}),
    # qwen2-vl-72b (arXiv:2409.12191) at full width, 4 of its 80 layers (80
    # do not fit one card even in bf16), stub patch embeddings
    "qwen2-vl-72b": dict(
        kernel="K4_flash_attention", record="K4_flash_attention_qwen2_vl",
        timing=phase_k4_timing, bf16_control=False,
        shapes={"full": dict(FULL, layers=4, f32_layers=2),
                "smoke": SMOKE}),
}


# phase 15, training: the smoke configs' step on the card against the CPU,
# the kill-and-resume recipe of tests/test_fault_tolerance.py, and
# rwkv6-1.6b at full width and depth through launch.train.main. "device"
# is the launcher's --device in the subprocesses (a CPU rehearsal sets it
# to "cpu").
TRAIN = dict(
    smoke=dict(batch=2, seq=32, steps=8),
    resume=["--arch", "qwen3-8b", "--smoke", "--steps", "24", "--batch", "2",
            "--seq", "32", "--ckpt-every", "8", "--lr", "1e-3"],
    die_at=12,
    full=dict(arch="rwkv6-1.6b", smoke=False, steps=12, batch=8, seq=512,
              lr=3e-3),
    # the CPU rehearsal: the smoke config, whose small batches need a
    # larger lr than the launcher's default for the loss to fall in 12
    rehearsal=dict(arch="rwkv6-1.6b", smoke=True, steps=12, batch=8, seq=64,
                   lr=3e-2),
    device="cuda",
    timeout=300,             # seconds per launcher subprocess
)
# card against CPU, one f32 step: loss and grad norm relative; the clipped
# gradient of every parameter (from AdamW's first moment) to atol + rtol
# |g|, as the CPU tests hold gradients; params absolute, except where
# AdamW's first update g / (|g| + eps) is ill-conditioned
# (0 < |g| < 100 eps), held to the update's bound 2 lr, and those at most
# ill_share of the parameters (the ten smoke configs' share at B 2 x S 32
# is 4.3e-4 to 1.85e-3: the MoE experts and the clipped rwkv6 lie above
# the 1e-3 the CPU tests hold four configs to)
TRAIN_TOL = dict(loss=1e-5, grad_norm=1e-4, grads=(1e-5, 1e-4),
                 params=1e-5, ill_share=1e-2)


def train_batch(torch, cfg, B, S, dev, step=0):
    """The token pipeline's batch at ``step`` on ``dev``; the VLM's stub
    frames in the compute type (the pipeline gives bf16)."""
    from repro_torch.data.pipeline import TokenPipeline, place
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, global_batch=B,
                         seq_len=S, seed=SEED, frontend=cfg.frontend,
                         d_model=cfg.d_model, mrope=cfg.mrope)
    batch = place(pipe.batch_at(step), dev)
    if "embeds" in batch:
        batch["embeds"] = batch["embeds"].to(cfg.compute_dtype)
    return batch


def adam_param_diff(torch, p_card, p_cpu, state_card, state_cpu, b1, eps):
    """(largest |card - CPU| over the parameters whose AdamW gradient is
    not within 100 eps of 0, the same over those that are (0 if none),
    how many are, how many parameters there are, and the largest
    |g_card - g_CPU| / (atol + rtol |g_CPU|) of the clipped gradients,
    read from the first moments m = (1 - b1) g: at most 1 where they
    agree to TRAIN_TOL["grads"])."""
    from repro_torch.models.model import zip_leaves
    atol, rtol = TRAIN_TOL["grads"]
    well, ill, n_ill, total, g_err = 0.0, 0.0, 0, 0, 0.0
    for a, b, m_card, m in zip_leaves(p_card, p_cpu, state_card["m"],
                                      state_cpu["m"]):
        total += b.numel()
        d = (a.cpu() - b).abs()
        g = m.abs() / (1 - b1)
        g_err = max(g_err, float(((m_card.cpu() - m).abs() / (1 - b1)
                                  / (atol + rtol * g)).max()))
        flat = (g < 100 * eps) & (g > 0)
        if bool((~flat).any()):
            well = max(well, float(d[~flat].max()))
        if bool(flat.any()):
            ill = max(ill, float(d[flat].max()))
            n_ill += int(flat.sum())
    return well, ill, n_ill, total, g_err


def phase_train_smoke(torch, B, S, steps):
    """Every arch's smoke config. In f32 compute: one train step on the card
    against the same step of the port on the CPU, from the same parameters
    and batch, then the card's step again from copies of the same inputs,
    bit for bit (no float atomics on the path; deterministic algorithms
    are not needed). As published (bf16 compute): ``steps``
    steps on a fixed batch, the loss must fall (the reference's
    test_smoke_loss_decreases); the median step time after two."""
    import repro_torch.configs as configs
    from repro_torch.models.model import init_params, tree_map, zip_leaves
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.runtime.steps import make_train_step
    dev = torch.device("cuda")
    tol = TRAIN_TOL
    for arch in configs.ALIASES:
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  compute_dtype=torch.float32)
        g = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, g)
        keep = tree_map(lambda t: t.clone(), params)
        p_cpu = tree_map(lambda t: t.to("cpu", copy=True), params)
        batch = train_batch(torch, cfg, B, S, dev)
        b_cpu = {k: v.to("cpu", copy=True) for k, v in batch.items()}
        opt = make_optimizer(cfg.optimizer, lr=1e-3, warmup_steps=1,
                             total_steps=10)
        step = make_train_step(cfg, opt)
        _, s_card, m_card = step(params, opt.init(params), batch, 0)
        _, s_cpu, m_cpu = step(p_cpu, opt.init(p_cpu), b_cpu, 0)
        e_loss = abs(float(m_card["loss"]) - float(m_cpu["loss"])) \
            / abs(float(m_cpu["loss"]))
        e_gn = abs(float(m_card["grad_norm"]) - float(m_cpu["grad_norm"])) \
            / float(m_cpu["grad_norm"])
        lr = float(opt.schedule(0))
        well, ill, n_ill, total, g_err = adam_param_diff(
            torch, params, p_cpu, s_card, s_cpu, opt.b1, opt.eps)
        again = tree_map(lambda t: t.clone(), keep)
        _, _, m_again = step(again, opt.init(again), batch, 0)
        bitwise = float(m_again["loss"]) == float(m_card["loss"]) and all(
            torch.equal(a, b) for a, b in zip_leaves(again, params))
        check(e_loss <= tol["loss"] and e_gn <= tol["grad_norm"]
              and well <= tol["params"] and ill <= 2 * lr
              and n_ill <= tol["ill_share"] * total and g_err <= 1
              and bitwise
              and all(math.isfinite(float(v)) for v in m_card.values()),
              f"train {arch} f32, one step card vs CPU: loss "
              f"{float(m_card['loss']):.5f} rel {e_loss:.2e} <= "
              f"{tol['loss']:g}, grad norm {float(m_card['grad_norm']):.4f}"
              f" rel {e_gn:.2e} <= {tol['grad_norm']:g}, params max "
              f"{well:.2e} <= {tol['params']:g} ({n_ill} of {total} <= "
              f"{tol['ill_share']:g} of them with 0 < |g| < 100 eps: "
              f"{ill:.2e} <= 2 lr = {2 * lr:.1e}); clipped gradients "
              f"{g_err:.2e} of atol {tol['grads'][0]:g} + rtol "
              f"{tol['grads'][1]:g} (<= 1); the card's step "
              f"repeats bit for bit: {bitwise}")
        del params, keep, again, p_cpu, s_card, s_cpu
        # as published (bf16 compute): the loss falls on a fixed batch
        cfg = configs.get_smoke(arch)
        params = init_params(cfg, g)
        batch = train_batch(torch, cfg, B, S, dev, step=1)
        opt = make_optimizer("adamw", lr=3e-3, warmup_steps=0,
                             total_steps=100)
        step = make_train_step(cfg, opt)
        state = opt.init(params)
        losses, times = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            params, state, met = step(params, state, batch, i)
            losses.append(float(met["loss"]))
            times.append(time.perf_counter() - t0)
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"train {arch} (bf16 compute): loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} over {steps} steps on a fixed batch "
              f"({B}x{S}), median step "
              f"{statistics.median(times[2:]) * 1e3:.1f} ms")
        del params, state
    free_device_memory(torch)


def phase_train_guard(torch):
    """K4 and K5 on the card raise under grad when an input requires grad
    (they have no backward), and launch without grad."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.wkv import ops as wkv_ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    q, k, v = (torch.randn((1, 4, 64, 64), generator=g, device=dev)
               for _ in range(3))
    w = -torch.rand((1, 4, 64, 64), generator=g, device=dev)
    u = torch.randn((4, 64), generator=g, device=dev)
    qg = q.clone().requires_grad_(True)
    raised = []
    for name, call in (
            ("K4", lambda: attn_ops.flash_attention(qg, k, v)),
            ("K5", lambda: wkv_ops.wkv(qg, k, v, w, u, chunk=16))):
        try:
            call()
        except RuntimeError as e:
            raised.append((name, "has no backward" in str(e)))
    before = (attn_ops.flash_attention.launches, wkv_ops.wkv.launches)
    with torch.no_grad():
        attn_ops.flash_attention(qg, k, v)
        wkv_ops.wkv(qg, k, v, w, u, chunk=16)
    torch.cuda.synchronize()
    after = (attn_ops.flash_attention.launches, wkv_ops.wkv.launches)
    check(raised == [("K4", True), ("K5", True)]
          and after == (before[0] + 1, before[1] + 1),
          f"train guard: K4 and K5 raise under grad with an input that "
          f"requires grad ({raised}); under no_grad each launches once")


def train_cli(args):
    """``python -m repro_torch.launch.train`` started in a subprocess from
    the checkout (:func:`finish` waits for it)."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + args,
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def finish(proc, timeout):
    """(returncode, stdout, stderr) of a :func:`train_cli` process; kills
    it and fails past ``timeout`` seconds."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        fail(f"train subprocess passed {timeout} s: {err[-2000:]}")
    return proc.returncode, out, err


def final_loss(out: str) -> float:
    import re
    m = re.search(r"\[done\] final loss \S+ \(first \S+\); exact (\S+)",
                  out)
    if not m:
        fail(f"train: no final loss in {out[-2000:]}")
    return float(m.group(1))


def phase_train_resume(torch):
    """tests/test_fault_tolerance.py's recipe on the card: the launcher
    uninterrupted, and killed at step 12 (after the step-8 checkpoint) then
    resumed; the final losses within rtol 1e-5, difference and bitwise
    equality printed. The first two run at once."""
    import tempfile
    common = TRAIN["resume"] + ["--device", TRAIN["device"]]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref = train_cli(common + ["--ckpt-dir", f"{tmp}/ref"])
        crash = train_cli(common + ["--ckpt-dir", f"{tmp}/ft",
                                    "--die-at-step", str(TRAIN["die_at"])])
        rc_ref, out_ref, err_ref = finish(ref, TRAIN["timeout"])
        rc_crash, out_crash, _ = finish(crash, TRAIN["timeout"])
        check(rc_ref == 0, f"train resume: the uninterrupted run exits 0 "
              f"({err_ref[-2000:]})")
        check(rc_crash != 0 and "[failure-injection] SIGKILL" in out_crash,
              f"train resume: the run killed at step {TRAIN['die_at']} "
              f"exits {rc_crash}")
        rc, out_res, err_res = finish(
            train_cli(common + ["--ckpt-dir", f"{tmp}/ft"]),
            TRAIN["timeout"])
    check(rc == 0 and "[resume] restored step" in out_res,
          f"train resume: the resumed run restores a checkpoint and exits "
          f"0 ({err_res[-2000:]})")
    a, b = final_loss(out_ref), final_loss(out_res)
    check(abs(a - b) <= 1e-5 * abs(a),
          f"train resume on the card: final loss uninterrupted {a!r}, "
          f"resumed {b!r}, |diff| {abs(a - b):.3e} <= 1e-5 x |loss|; "
          f"bitwise equal: {a == b}; {time.perf_counter() - t0:.1f} s for "
          "the three runs")


def device_busy(torch, fn):
    """(host ms, device-busy ms, kernels, the six kernel names of most
    device time as (ms, launches, name)) of ``fn()`` under
    ``torch.profiler`` (CUDA activity only): busy is the union of the
    kernels' intervals. The profiler adds host time per launch, so the
    host ms is an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(kernels) > 0, "torch.profiler recorded the card's kernels")
    busy, end, by_name = 0, None, {}
    for a, b, name in sorted((e.time_range.start, e.time_range.end, e.name)
                             for e in kernels):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
        t, n = by_name.get(name, (0, 0))
        by_name[name] = (t + b - a, n + 1)
    ranked = sorted(((t / 1e3, n, name[:60]) for name, (t, n)
                     in by_name.items()), reverse=True)[:6]
    return host * 1e3, busy / 1e3, len(kernels), ranked


def leaf_paths(tree, prefix=""):
    """(path, tensor) of every leaf of a nest of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def leaf_grad_norms(torch, cfg, params, batch):
    """{leaf path: (gradient norm, per-layer norms of a stacked leaf, else
    None)} of the train step's loss (the chunked paths) at ``params``."""
    from repro_torch.models.model import loss_fn
    named = list(leaf_paths(params))
    for _, p in named:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, _ = loss_fn(params, cfg, batch, attn_impl="xla",
                              wkv_impl="xla")
            grads = torch.autograd.grad(loss, [p for _, p in named],
                                        allow_unused=True)
    finally:
        for _, p in named:
            p.requires_grad_(False)
    out = {}
    for (name, p), g in zip(named, grads):
        g = torch.zeros_like(p, dtype=torch.float32) if g is None \
            else g.float()
        stacked = name.startswith(("blocks", "enc_blocks"))
        out[name] = (float(g.norm()), g.reshape(g.shape[0], -1).norm(
            dim=1).tolist() if stacked else None)
    del grads
    return out


def print_grad_norms(arch, norms, rank_by, top=8):
    """``norms``: {step: leaf_grad_norms}. The leaves of most gradient at
    step ``rank_by``, each with its share of the squared norm at every
    step; the per-layer norms of the top three stacked leaves."""
    tot = {i: sum(n * n for n, _ in d.values()) for i, d in norms.items()}
    ranked = sorted(norms[rank_by], key=lambda k: norms[rank_by][k][0],
                    reverse=True)
    for name in ranked[:top]:
        print(f"train {arch} grad norm {name}: " + ", ".join(
            f"step {i} {d[name][0]:.3e} ({d[name][0] ** 2 / tot[i]:.1%})"
            for i, d in norms.items()), flush=True)
    for name in [k for k in ranked if norms[rank_by][k][1] is not None][:3]:
        for i, d in norms.items():
            print(f"train {arch} grad norm {name} by layer, step {i}: "
                  + " ".join(f"{x:.2e}" for x in d[name][1]), flush=True)


def phase_train_full(torch, sh):
    """``launch.train.main`` at the arch's width and depth (no checkpoint
    directory): the median step time after two warm-up steps, tok/s, the
    peak device memory, the first and last loss (finite, falling). Then
    the same run again step by step as far as it needs, held to the
    launcher's losses: the gradient norm of every leaf at its first step
    and at the step of the largest norm, and its step 2 under
    ``torch.profiler`` (the card's busy time beside the step's)."""
    import repro_torch.configs as configs
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.runtime.steps import make_train_step
    arch = sh["arch"]
    cfg = configs.get_smoke(arch) if sh["smoke"] else configs.get(arch)
    B, S = sh["batch"], sh["seq"]
    args = ["--arch", arch, "--steps", str(sh["steps"]), "--batch", str(B),
            "--seq", str(S), "--seed", str(SEED), "--log-every", "1",
            "--lr", repr(sh["lr"]), "--device", "cuda"] \
        + ["--smoke"] * sh["smoke"]
    n = cfg.param_count() + extra_params(cfg)
    print(f"train: {' '.join(args)}; {n} parameters, f32 weights, "
          f"gradients and two AdamW moments {16 * n / 1e9:.1f} GB, remat "
          f"{cfg.remat}", flush=True)
    free_device_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.main(args)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses, timed = run["losses"], run["step_s"][2:]
    # per leaf at the first and the largest gradient norm's step
    spike = max(range(len(losses)), key=run["grad_norms"].__getitem__)
    probe = sorted({0, spike})
    ms = statistics.median(timed) * 1e3
    # 6 N T: forward and backward matmul work, the embedding gather aside
    # (remat recomputes the forward on top)
    flops = 6 * (n - cfg.vocab_size * cfg.d_model) * B * S
    label = "smoke" if sh["smoke"] else "full"
    head, tail = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0]
          and tail < head,
          f"train {arch} {label}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(mean of the first three {head:.4f}, of the last three "
          f"{tail:.4f}) over {len(losses)} steps of {B}x{S}, finite and "
          f"falling")
    print(f"train {arch} {label} ({B}x{S}, remat {cfg.remat}): median step "
          f"{ms:.1f} ms over {len(timed)} steps (min {min(timed) * 1e3:.1f}"
          f", max {max(timed) * 1e3:.1f}), {B * S / ms * 1e3:.0f} tok/s, "
          f"6NT {flops / ms / 1e9:.1f} TFLOP/s, peak device memory "
          f"{peak:.2f} GB, {secs:.1f} s with init", flush=True)
    del run
    free_device_memory(torch)
    # the launcher's run again, step by step up to the later of the spike
    # and step 2: the gradient norm of every leaf at the steps in probe,
    # and step 2 under the profiler
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    opt = make_optimizer(cfg.optimizer, lr=sh["lr"],
                         total_steps=max(sh["steps"], 2))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    again, norms = [], {}
    for i in range(max(spike, 2) + 1):
        batch = train_batch(torch, cfg, B, S, dev, step=i)
        if i in probe:
            norms[i] = leaf_grad_norms(torch, cfg, params, batch)
        if i == 2:
            host, busy, n_k, top = device_busy(
                torch, lambda: again.append(step(params, state, batch, i)[2]))
        else:
            again.append(step(params, state, batch, i)[2])
    gn = {i: (math.sqrt(sum(x * x for x, _ in norms[i].values())),
              float(again[i]["grad_norm"])) for i in probe}
    rerun = [float(m["loss"]) for m in again]
    check(all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(rerun, losses))
          and all(abs(a - b) <= 1e-4 * b for a, b in gn.values()),
          f"train {arch} {label} again step by step: losses within 1e-5 of "
          f"the launcher's (bit for bit: {rerun == losses[:len(rerun)]}); "
          f"the leaves' "
          f"gradient norms give the step's grad norm within 1e-4 ("
          + ", ".join(f"step {i} {a:.4e} / {b:.4e}" for i, (a, b)
                      in gn.items())
          + f"); {time.perf_counter() - t0:.1f} s")
    print_grad_norms(arch, norms, spike)
    print(f"train {arch} profiled step: {n_k} kernels, card busy "
          f"{busy:.1f} ms of the profiled step's {host:.1f} ms; against the "
          f"median step {ms:.1f} ms the card idles "
          f"{max(0.0, 1 - busy / ms):.1%}", flush=True)
    for k_ms, k_n, name in top:
        print(f"train {arch} profiled step: {k_ms:9.2f} ms {k_n:6d} x "
              f"{name}", flush=True)
    del params, state
    free_device_memory(torch)


# ---------------------------------------------------------------------------
# phase 16: all-to-all expert parallelism on a (1 data x 4 model) grid
# ---------------------------------------------------------------------------

# olmoe-1b-7b (arXiv:2409.02060) at full width and depth on 4 gloo ranks
# sharing the card; the layer checks in f32 compute, the forward as
# published (bf16 compute)
A2A = dict(arch="olmoe-1b-7b", grid=((1, 4), ("data", "model")), batch=2,
           seq=4096, layers=None, cpu_threads=2, timeout=400.0,
           # tokens whose output may differ beyond the bound: a near-tie of
           # the k-th and (k+1)-th router probabilities that two f32 GEMMs
           # of different row counts round apart
           flip_share=1e-3)


def a2a_no_drop(cfg, M: int):
    """(send_cf, recv_cf) under which ``moe_ffn_a2a_local`` drops nothing
    on any routing: Csend = T_loc k (every pair of a rank fits one
    destination), C_loc = M T_loc (every token of the line fits one
    expert)."""
    return float(M), cfg.num_experts // M / cfg.experts_per_token


def a2a_fwd_capacity(torch, cfg, routes, B, S, M, margin=1.1):
    """The capacity factor of the a2a forward: the least, in steps of
    1/64, at which both of ``moe_ffn_a2a``'s stages hold ``margin`` times
    the single-rank forward's routing (``routes``): stage 1 the most pairs
    any rank sent any destination in any layer, stage 2 the most pairs any
    expert took in any layer (the a2a forward's own routing may flip a
    near-tie). The forward's drop count is checked."""
    from repro_torch.models import moe_a2a
    E, k = cfg.num_experts, cfg.experts_per_token
    T_loc, E_loc = B * S // M, E // M
    worst1 = worst2 = 0
    for r in routes:
        worst2 = max(worst2, int(torch.bincount(r.reshape(-1),
                                                minlength=E).max()))
        dest = r.reshape(B, M, S // M, k) // E_loc          # (B, m, s, k)
        for m in range(M):
            c = torch.bincount(dest[:, m].reshape(-1), minlength=M)
            worst1 = max(worst1, int(c.max()))
    cf = 1.0
    while True:
        Csend, C_loc = moe_a2a.capacities(
            dataclasses.replace(cfg, capacity_factor=cf), T_loc, M)
        if Csend >= worst1 * margin and C_loc >= worst2 * margin:
            return cf
        cf += 1 / 64


def a2a_rank(plan, layer, params, x, tokens, routes):
    """One rank of phase 16 (``compat.spawn``): joins the grid, runs the
    MoE layer as ``plan``'s ``layer_runs`` say (name, capacities, and
    whether on the card or on the CPU: the same gloo ranks then hold CPU
    copies of the layer and compute on ``cpu_threads`` threads each):
    ``moe_ffn_a2a`` at the config's capacity, or its local body at given
    (send_cf, recv_cf) on this rank's positions and expert shard, gathered
    over the line. Then the bf16 forward through ``model.forward`` with
    ``moe_impl="a2a"``, timed and counted, and again with the experts
    pinned to the single-rank forward's choices (``moe_routes``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import moe_a2a
    from repro_torch.roofline import hlo
    from repro_torch.sharding import compat, specs

    grid = compat.join_grid(compat.make_grid(*plan["grid"]))
    first = grid.rank == 0
    M, m = grid.axis_size("model"), grid.index("model")
    group = grid.group("model")
    B, S, d = x.shape
    Sl = S // M
    out = {}

    def sync(t):
        if t.is_cuda:
            torch.cuda.synchronize()

    def drops():
        stats, moe_lib.DROP_STATS = moe_lib.DROP_STATS, None
        return (sum(int(k) for k, _ in stats), sum(r for _, r in stats),
                len(stats))

    def body(lp, cfg, xin, cf):
        spec = specs.param_spec(lp)
        mine = {key: specs.local_slice(v, spec[key], grid)
                for key, v in lp.items()}
        o, _ = moe_a2a.moe_ffn_a2a_local(
            mine, cfg, xin[:, m * Sl:(m + 1) * Sl].reshape(B * Sl, d),
            group=group, M=M, send_cf=cf[0], recv_cf=cf[1])
        return compat.all_gather_cat(o.reshape(B, Sl, d), group, dim=1)

    with compat.use_grid(grid), torch.inference_mode():
        threads = torch.get_num_threads()
        for name, cf, on_cpu in plan["layer_runs"]:
            lp, xin = layer, x
            if on_cpu:
                lp = {key: v.cpu() for key, v in layer.items()}
                xin = x.cpu()
                torch.set_num_threads(plan["cpu_threads"])
            moe_lib.DROP_STATS = []
            t0 = time.perf_counter()
            if cf is None:
                o, _ = moe_a2a.moe_ffn_a2a(lp, plan["cfg_f32"], xin)
            else:
                o = body(lp, plan["cfg_f32"], xin, cf)
            sync(o)
            out[name] = (o if first else None, drops(),
                         time.perf_counter() - t0)
            torch.set_num_threads(threads)
            del lp, xin
        cfg = plan["cfg_fwd"]
        mine = [r.reshape(B, -1, r.shape[-1])[:, m * Sl:(m + 1) * Sl]
                .reshape(-1, r.shape[-1]) for r in routes]
        # warm-up: one layer (K4's library, the bf16 products' handles)
        model_lib.forward(params, dataclasses.replace(cfg, num_layers=1),
                          tokens=tokens)
        zero_counts(attn_ops.flash_attention)
        moe_lib.DROP_STATS = []
        sync(x)
        dist.barrier()
        with hlo.CollectiveRecorder() as rec:
            t0 = time.perf_counter()
            h, _ = model_lib.forward(params, cfg, tokens=tokens)
            sync(h)
            dist.barrier()
            ms = (time.perf_counter() - t0) * 1e3
        out["forward"] = dict(
            h=h if first else None, ms=ms, drops=drops(), ops=rec.ops,
            launches=attn_ops.flash_attention.launches,
            routes=route_counts(attn_ops.flash_attention))
        moe_lib.DROP_STATS = []
        with moe_routes(torch, replay=mine):
            h, _ = model_lib.forward(params, cfg, tokens=tokens)
        out["pinned"] = (h if first else None, drops())
    return out


def a2a_close(torch, got, want, share):
    """(max |got - want| / max |want| over the tokens within 1e-3 of it,
    the share of tokens beyond that): a routing flip moves a token by
    O(1), and such tokens are counted apart and bounded by ``share``."""
    d = (got.float() - want.float()).abs().amax(dim=-1)
    top = float(want.float().abs().max())
    moved = d > 1e-3 * top
    rest = float(d[~moved].max()) / top if bool((~moved).any()) else 0.0
    return rest, float(moved.float().mean())


def phase_a2a(torch, rt, smoke: bool = False):
    """Phase 16: ``models.moe_a2a`` on olmoe-1b-7b at full width on a
    (1 data x 4 model) grid of gloo ranks sharing the card (see the module
    docstring); then the dry-run's roofline beside phase 4's measurement."""
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attn.ops import route
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import moe_a2a
    from repro_torch.models.model import forward, init_params
    from repro_torch.sharding import compat

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = configs.get_smoke(A2A["arch"]) if smoke \
        else configs.get(A2A["arch"])
    if A2A["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=A2A["layers"])
    B, S = (2, 32) if smoke else (A2A["batch"], A2A["seq"])
    (_, M), axes = A2A["grid"]
    E_loc, k = cfg.num_experts // M, cfg.experts_per_token
    g = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, g)
    torch.cuda.synchronize()
    print(f"a2a: {cfg.name}, {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_experts} experts top-{k} ({E_loc} a rank) on a "
          f"{A2A['grid'][0]} grid of gloo ranks sharing the card; weights "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    nodrop = a2a_no_drop(cfg, M)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    # the single-rank forward on the card at capacity E / k, where nothing
    # can drop; it records each MoE layer's input (the hidden states after
    # attention) and routing
    own_ffn, seen = moe_lib.moe_ffn, []

    def grab(p, c, xin, **kw):
        seen.append(xin)
        return own_ffn(p, c, xin, **kw)

    with torch.inference_mode():
        one = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / k)
        routes = []
        moe_lib.DROP_STATS = []
        moe_lib.moe_ffn = grab
        try:
            with moe_routes(torch, record=routes):
                h_one, _ = forward(params, one, tokens=tokens)
        finally:
            moe_lib.moe_ffn = own_ffn
        torch.cuda.synchronize()
        one_drop = drop_share(moe_lib.DROP_STATS)
        # the layer checks take the layer whose input ``moe_ffn`` drops
        # most of at the config's capacity: the drop rule at work
        shares = []
        for li, xin in enumerate(seen):
            lp = {key: v[li] for key, v in params["blocks"][0]["moe"].items()}
            moe_lib.DROP_STATS = []
            moe_lib.moe_ffn(lp, cfg, xin)
            shares.append(drop_share(moe_lib.DROP_STATS))
        moe_lib.DROP_STATS = None
        li = max(range(len(shares)), key=shares.__getitem__)
        layer = {key: v[li] for key, v in params["blocks"][0]["moe"].items()}
        x = seen[li].float()
        del seen, lp, xin
        dense = moe_lib.moe_ffn_dense_ref(layer, f32, x)
    check(one_drop == 0.0, f"a2a: the single-rank forward at capacity "
          f"{one.capacity_factor:g} drops nothing ({one_drop})")
    print(f"a2a: moe_ffn's drop share at capacity {cfg.capacity_factor} by "
          f"layer {[round(v, 4) for v in shares]}: the layer checks take "
          f"layer {li}", flush=True)
    fwd = dataclasses.replace(cfg, capacity_factor=a2a_fwd_capacity(
        torch, cfg, routes, B, S, M))
    # the layer at the config's capacity on the card and, on the same
    # gloo ranks, on the CPU
    plan = dict(grid=A2A["grid"], cfg_f32=f32, cfg_fwd=fwd,
                cpu_threads=A2A["cpu_threads"],
                layer_runs=[("nodrop", nodrop, False), ("cap", None, False),
                            ("cpu", None, True)])
    t0 = time.perf_counter()
    ranks = compat.spawn(a2a_rank, M, "gloo",
                         args=(plan, layer, params, x, tokens, routes),
                         device=dev.type, timeout=A2A["timeout"])
    print(f"a2a: {M} ranks spawned, run and joined in "
          f"{time.perf_counter() - t0:.1f} s (the layer at no-drop "
          f"capacities {max(r['nodrop'][2] for r in ranks):.2f} s; at the "
          f"config's {max(r['cap'][2] for r in ranks):.2f} s on the card, "
          f"{max(r['cpu'][2] for r in ranks):.2f} s on the CPU, "
          f"{A2A['cpu_threads']} threads a rank)", flush=True)

    # 1. one MoE layer at the forward shape, f32 compute
    T = B * S
    flip = A2A["flip_share"]
    o_nd, (kept, routed, _) = ranks[0]["nodrop"][0], (
        sum(r["nodrop"][1][0] for r in ranks),
        sum(r["nodrop"][1][1] for r in ranks), None)
    check(kept == routed == T * k,
          f"a2a layer, no-drop capacities (send_cf {nodrop[0]:g}, recv_cf "
          f"{nodrop[1]:g}): {kept} of {routed} pairs kept")
    err, moved = a2a_close(torch, torch.as_tensor(o_nd, device=dev), dense,
                           flip)
    check(err <= 1e-4 and moved <= flip,
          f"a2a layer {B}x{S} f32 vs moe_ffn_dense_ref on the card: max "
          f"|d| / max |ref| {err:.2e} <= 1e-4 over the tokens within 1e-3; "
          f"tokens beyond {moved:.2e} <= {flip:g} (routing flips)")
    o_cap = torch.as_tensor(ranks[0]["cap"][0], device=dev)
    o_cpu = torch.as_tensor(ranks[0]["cpu"][0], device=dev)
    d_card = sum(r["cap"][1][1] - r["cap"][1][0] for r in ranks)
    d_cpu = sum(r["cpu"][1][1] - r["cpu"][1][0] for r in ranks)
    err, moved = a2a_close(torch, o_cap, o_cpu, flip)
    print(f"a2a layer {li} at capacity {cfg.capacity_factor}, B {B} x S "
          f"{S}: {d_card} of {T * k} (token, expert) pairs dropped on the "
          f"card ({d_card / (T * k):.4f}), {d_cpu} on the CPU ranks",
          flush=True)
    check(err <= 1e-4 and moved <= flip and abs(d_card - d_cpu)
          <= k * moved * T,
          f"a2a layer at capacity {cfg.capacity_factor}, card ranks vs CPU "
          f"ranks: max |d| / max |ref| {err:.2e} <= 1e-4 over the tokens "
          f"within 1e-3, tokens beyond {moved:.2e} <= {flip:g}, dropped "
          f"pairs {d_card} vs {d_cpu} (apart by at most k x the tokens "
          "beyond)")
    del dense, o_nd, o_cap, o_cpu
    if smoke:
        return

    # 2. the forward through model.forward with moe_impl "a2a"
    fw = [r["forward"] for r in ranks]
    ms = max(f["ms"] for f in fw)
    for name, st in (("", [f["drops"] for f in fw]),
                     (", experts pinned", [r["pinned"][1] for r in ranks])):
        d_kept, d_routed = sum(d[0] for d in st), sum(d[1] for d in st)
        check(d_kept == d_routed == T * k * cfg.num_layers,
              f"a2a forward{name} at capacity {fwd.capacity_factor:g}: "
              f"{d_kept} of {d_routed} pairs kept")
    want = route(cfg.compute_dtype, cfg.head_dim)
    for r, f in enumerate(fw):
        check(f["launches"] == cfg.num_layers
              and f["routes"][want] == cfg.num_layers,
              f"a2a forward, rank {r}: K4 launched {f['launches']} times = "
              f"{cfg.num_layers} layers, on the {want} route {f['routes']}")
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    lg_one = h_one[:, -64:].float() @ head.float()
    for name, h in (("free", fw[0]["h"]), ("pinned", ranks[0]["pinned"][0])):
        lg = torch.as_tensor(h, device=dev)[:, -64:].float() @ head.float()
        e_max, e_mean = rel_diffs(torch, lg, lg_one)
        if name == "free":
            print(f"a2a forward vs single-rank forward (experts free), "
                  f"last 64 positions' logits: max |d| / max {e_max:.2e}, "
                  f"mean {e_mean:.2e}", flush=True)
        else:
            check(e_max <= 1e-1 and e_mean <= 5e-2,
                  f"a2a forward vs single-rank forward, experts pinned to "
                  f"the single rank's, last 64 positions' logits bf16: max "
                  f"|d| / max {e_max:.2e} <= 1e-1, mean {e_mean:.2e} <= "
                  "5e-2 (the dense families' fixed bounds)")
    hops = [o for o in fw[0]["ops"] if o["kind"] == "all-to-all"]
    T_loc = T // M
    Csend, C_loc = moe_a2a.capacities(fwd, T_loc, M)
    token_bytes = sum(o["bytes"] for o in hops
                      if o["bytes"] != M * Csend * 8) / cfg.num_layers
    formula = moe_a2a.hop_bytes(fwd, T_loc, M, 2)
    check(len(hops) == 3 * cfg.num_layers and token_bytes == formula,
          f"a2a forward: {len(hops)} all-to-alls = 3 a layer; the token "
          f"hops {token_bytes:.0f} B a layer a rank (recorded) = 2 x Csend "
          f"{Csend} x M {M} x d {cfg.d_model} x 2 B = {formula} (formula)")
    print(f"a2a forward {B}x{S}, {cfg.num_layers} layers, bf16, on {M} "
          f"ranks: {ms:.1f} ms a forward (slowest rank); {M} ranks x "
          f"{token_bytes / 1e6:.1f} MB of token hops a layer, staged "
          f"through pinned host memory [{smi_line()}]", flush=True)
    del ranks, fw, h_one, lg_one, routes, params, layer, x
    print(f"a2a: freed, {free_device_memory(torch):.2f} GB still allocated",
          flush=True)

    # 3. the dry-run's roofline beside phase 4's measurement
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    star = dryrun.run_fit_cell("star_f32", multi_pod=False, out_dir=None,
                               quiet=True)
    main = dryrun.run_fit_cell(
        dict(m=M_MAIN, n=307, dtype=torch.float32), multi_pod=False,
        out_dir=None, grid=compat.make_grid((1,), ("data",)), quiet=True)

    def terms(t):
        return (f"compute {t['compute_s'] * 1e3:.3f} ms, memory "
                f"{t['memory_s'] * 1e3:.3f} ms, collective "
                f"{t['collective_s'] * 1e3:.4f} ms ({t['bottleneck']})")

    for phase in ("setup", "iter", "fused_iter"):
        print(f"dry-run star_f32 on {make_production_mesh().shape}, "
              f"{phase}: {terms(star[phase]['roofline'])}", flush=True)
    k3 = [r for r in rt["records"] if r["name"] == "K3_admm_iter"]
    per_iter = rt["local_f32"][2] if "local_f32" in rt else float("nan")
    print(f"dry-run main path {M_MAIN} x 307 f32 at world 1, fused_iter "
          f"(unfused bytes): {terms(main['fused_iter']['roofline'])}; "
          f"measured {per_iter:.2f} ms/iter (phase 4), K3 "
          f"{k3[0]['ms'] if k3 else float('nan'):.3f} ms, bound "
          f"{k3[0]['bound_ms'] if k3 else float('nan'):.3f} ms "
          f"[{smi_line()}]", flush=True)
    print(f"a2a phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_train(torch, smoke: bool):
    sm = TRAIN["smoke"]
    t0 = time.perf_counter()
    phase_train_smoke(torch, sm["batch"], sm["seq"], sm["steps"])
    t1 = time.perf_counter()
    phase_train_guard(torch)
    phase_train_resume(torch)
    t2 = time.perf_counter()
    phase_train_full(torch, TRAIN["rehearsal" if smoke else "full"])
    print(f"train phase: smoke configs {t1 - t0:.1f} s, guard and resume "
          f"{t2 - t1:.1f} s, full {time.perf_counter() - t2:.1f} s",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=M_MAIN,
                    help="rows of the main-path problem")
    ap.add_argument("--skip-main", action="store_true",
                    help="stop after the kernel checks (no result lines)")
    ap.add_argument("--lm-smoke", action="store_true",
                    help="run the LM phases at the smoke configs and toy "
                    "shapes (a rehearsal, not a measurement)")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    # the card's published peaks: the table the roofline terms read too
    from repro_torch.roofline.hlo import peaks
    peak_key, (bw, flops, tc) = peaks(name)
    print(f"device: {smi} (peaks of {peak_key}: {bw / 1e12:.2f} TB/s, "
          f"{flops / 1e12:.0f} TFLOP/s FP32, {tc / 1e12:.1f} TFLOP/s bf16 "
          f"tensor); torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    rt = {"peaks": (bw, flops, tc), "records": []}

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f}s",
          flush=True)

    phase_kernels(torch, rt)
    phase_sparse_kernels(torch)
    phase_attn_kernels(torch)
    phase_wkv_kernels(torch)
    if args.skip_main:
        return
    phase_main(torch, rt, args.rows, ITERS)
    phase_timing(torch, rt, REPS)
    phase_shard_map(torch, rt, REPS)
    phase_obs_main(torch, rt)
    # the ADMM main path's D (20.6 GB) goes before the LM weights
    del rt["main"]
    print(f"admm: freed, {free_device_memory(torch):.2f} GB still "
          "allocated", flush=True)
    phase_problems(torch, rt, REPS)
    phase_sparse(torch, rt, REPS)
    cluster = phase_ooc(torch, rt, REPS)
    phase_cluster(torch, rt, cluster)
    for arch, spec in LM.items():
        sh = spec["shapes"]["smoke" if args.lm_smoke else "full"]
        t0 = time.perf_counter()
        phase_lm(torch, rt, arch, sh, args.lm_smoke)
        phase_serve(torch, rt, arch, sh, args.lm_smoke)
        spec["timing"](torch, rt, REPS, arch, sh, args.lm_smoke)
        print(f"lm phase {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    t0 = time.perf_counter()
    phase_lm_smoke_configs(torch, rt, REPS)
    print(f"lm phase smoke configs: {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_a2a(torch, rt, args.lm_smoke)
    # training, once the LM phases' weights are freed
    phase_train(torch, args.lm_smoke)
    print(json.dumps({"kernels": rt["records"]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
