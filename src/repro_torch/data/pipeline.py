"""Deterministic data pipeline for LM training; port of
``repro/data/pipeline.py``.

Synthetic-token LM stream with the properties the fault-tolerance layer
needs: (a) every (step, shard) batch is a pure function of (seed, step), no
pipeline state files; (b) restart at step k reproduces exactly the batches a
non-interrupted run would have seen; (c) elastic re-sharding (a different
number of workers) re-partitions the same global batch, so restarts on
another layout consume identical global data.

``batch_at`` is pure numpy on ``default_rng((seed, step))`` and gives the
reference's arrays bit for bit, with one difference of dtype: the
reference's vision and audio frames are ``emb.astype(jnp.bfloat16)``, an
``ml_dtypes`` array, and neither JAX nor ``ml_dtypes`` is a dependency of
the port. Those fields come back as float32 arrays that already hold the
bf16-rounded values (round to nearest even, as ``ml_dtypes`` and
``torch.Tensor.to(torch.bfloat16)`` both round), and :func:`place` casts
them to ``torch.bfloat16`` exactly.

A host-side prefetch thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

# fields that hold bf16-rounded values (the reference's bf16 arrays)
BF16_FIELDS = ("embeds", "enc_embeds")


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` without NaN rounded to the nearest bfloat16 (ties to
    even), as float32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def place(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A ``batch_at`` batch as tensors on ``device``: integer fields as
    int64, the frames (``BF16_FIELDS``) as bfloat16."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if k in BF16_FIELDS:
            t = t.to(torch.bfloat16)
        elif v.dtype.kind in "iu":
            t = t.long()
        out[k] = t
    return out


class TokenPipeline:
    def __init__(self, *, vocab_size: int, global_batch: int, seq_len: int,
                 seed: int = 0, frontend: str = "none", d_model: int = 0,
                 mrope: bool = False):
        self.vocab = vocab_size
        self.B = global_batch
        self.S = seq_len
        self.seed = seed
        self.frontend = frontend
        self.d_model = d_model
        self.mrope = mrope

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Global batch for ``step``: a pure function of (seed, step)."""
        rng = np.random.default_rng((self.seed, step))
        # Markov-ish synthetic stream: mixture of ngram-copy and uniform.
        toks = rng.integers(0, self.vocab, (self.B, self.S + 1), np.int32)
        copy_mask = rng.random((self.B, self.S + 1)) < 0.3
        toks[:, 1:][copy_mask[:, 1:]] = toks[:, :-1][copy_mask[:, 1:]]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.frontend == "vision":
            emb = rng.standard_normal(
                (self.B, self.S, self.d_model), np.float32) * 0.02
            batch = {"embeds": bf16_round(emb),
                     "labels": toks[:, 1:],
                     "positions": np.broadcast_to(
                         np.arange(self.S, dtype=np.int32),
                         (3, self.B, self.S)).copy()}
        elif self.frontend == "audio":
            emb = rng.standard_normal(
                (self.B, self.S, self.d_model), np.float32) * 0.02
            batch["enc_embeds"] = bf16_round(emb)
        return batch

    def shard_iterator(self, start_step: int, device=None,
                       prefetch: int = 2) -> Iterator:
        """Yields ``(step, batch)`` from ``start_step`` with a host
        prefetch thread; batches are numpy, or tensors on ``device`` when
        one is given (the reference takes shardings here)."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                b = self.batch_at(step)
                if device is not None:
                    b = place(b, device)
                q.put((step, b))
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
