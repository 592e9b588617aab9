"""olmoe-1b-7b [moe] — 16L d2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8 [arXiv:2409.02060]."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1024, vocab_size=50304,
        num_experts=64, experts_per_token=8, moe_d_ff=1024,
        capacity_factor=1.25, qk_norm=True, moe_impl="a2a",
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=64, moe_d_ff=64, vocab_size=256,
        num_experts=8, experts_per_token=4,
    )
