"""int8 error-feedback compression of the per-iteration n-vector; port of
``repro/cluster/compress.py``.

The transpose reduction ships one n-length vector per node per iteration
(the paper's O(n)-per-node communication claim). This module owns its
compression: ``core/distributed.py``'s compressed all-reduce quantizes
each rank's d-contribution here.

Scheme: blockwise symmetric int8. The vector is cut into ``block``-sized
groups, each scaled by its own max-abs / 127, so the wire payload is 1
byte per coordinate plus 4 bytes of scale per group (a ~3.9x reduction at
block = 256) instead of 4 bytes per coordinate. Error feedback
(``ef_compress``) keeps the quantization residual at the SENDER and adds
it to the next iteration's vector, so the bias of repeated rounding
vanishes over iterations.

The arithmetic is the reference's, operation for operation: the same
division by the scale, the 1e-30 scale floor and ``torch.round``, which
rounds half to even as ``jnp.round`` does, so both packages give the same
bits for the same input.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

DEFAULT_BLOCK = 256


def quantize_int8(v: Tensor, block: int = DEFAULT_BLOCK
                  ) -> Tuple[Tensor, Tensor]:
    """Blockwise symmetric int8 quantization: (q int8 (nb, block), scale
    f32 (nb, 1)). The tail group is zero-padded (dequantize truncates it
    back). The group size adapts down to n: without that, an n = 32 vector
    would be padded out to a 256-byte group and the "compressed" payload
    would exceed the 4n raw bytes."""
    n = v.shape[0]
    block = min(block, max(n, 1))
    nb = -(-n // block)
    vp = F.pad(v, (0, nb * block - n)).reshape(nb, block)
    scale = torch.amax(torch.abs(vp), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(vp / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: Tensor, scale: Tensor, n: int) -> Tensor:
    """Inverse of :func:`quantize_int8` (up to rounding): f32 (n,)."""
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


def ef_compress(v: Tensor, err: Tensor, block: int = DEFAULT_BLOCK
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Error-feedback quantization step: ``(q, scale, new_err)``.

    Quantizes ``v + err`` and returns the residual the sender carries into
    its next transmission. The receiver reconstructs with
    :func:`dequantize_int8`; summing reconstructions over iterations is
    unbiased because each sender's residual re-enters its own stream."""
    corrected = v + err
    q, scale = quantize_int8(corrected, block=block)
    new_err = corrected - dequantize_int8(q, scale, corrected.shape[0])
    return q, scale, new_err


def wire_bytes(n: int, compressed: bool, block: int = DEFAULT_BLOCK) -> int:
    """Payload bytes of one n-vector on the wire (excluding framing)."""
    if not compressed:
        return 4 * n
    block = min(block, max(n, 1))
    nb = -(-n // block)
    return nb * block + 4 * nb          # int8 payload + f32 scales
