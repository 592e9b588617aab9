"""qwen2-vl-72b [vlm] — 80L d8192 64H (GQA kv=8) d_ff=29568 vocab=152064,
M-RoPE (t/h/w sections 16/24/24), dynamic resolution [arXiv:2409.12191].
Vision frontend is a STUB: input_specs() provides patch embeddings +
3-stream M-RoPE position ids. kv_repeat=2 aligns kv heads to TP16."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=29568, vocab_size=152064,
        mrope=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
        kv_repeat=2, frontend="vision",
        fsdp=True, parallelism="fsdp",
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, kv_repeat=1,
        mrope_sections=(2, 3, 3),
    )
