"""Wire formats of the multi-rank reduction (port of ``repro.cluster``).
Only ``compress`` is ported; the cluster runtime is ROADMAP item 9."""
from repro_torch.cluster.compress import (
    DEFAULT_BLOCK,
    dequantize_int8,
    ef_compress,
    quantize_int8,
    wire_bytes,
)

__all__ = ["DEFAULT_BLOCK", "dequantize_int8", "ef_compress",
           "quantize_int8", "wire_bytes"]
