"""phi3-medium-14b [dense] — 40L d5120 40H (GQA kv=10) d_ff=17920
vocab=100352, RoPE SwiGLU GQA [arXiv:2404.14219]. kv_repeat=2 -> 20 kv heads
(GQA group 2); 40 q / 20 kv over 16-way TP still pads (see §Perf notes)."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
        head_dim=128, d_ff=17920, vocab_size=100352,
        kv_repeat=2, parallelism="fsdp",
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=80, num_heads=5, num_kv_heads=5,
        head_dim=16, d_ff=128, vocab_size=256, kv_repeat=1,
    )
