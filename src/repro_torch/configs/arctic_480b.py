"""arctic-480b [moe] — 35L d7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].
Adafactor (factored second moment) as the optimizer; kv_repeat=1: the GQA
group is 56/8=7, so no repeat aligns 16-way TP.
"""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=4864, vocab_size=32000,
        num_experts=128, experts_per_token=2, moe_d_ff=4864,
        moe_dense_residual=True, capacity_factor=1.25,
        kv_repeat=1, optimizer="adafactor",
        fsdp=True, moe_impl="a2a",
        skip_shapes=("long_500k",),   # pure full attention
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=8, num_kv_heads=8,
        head_dim=8, d_ff=96, moe_d_ff=96, vocab_size=256,
        num_experts=8, experts_per_token=2, optimizer="adamw",
    )
