"""qwen3-8b [dense] — 36L d4096 32H (GQA kv=8) d_ff=12288 vocab=151936,
qk_norm [hf:Qwen/Qwen3-8B]. kv_repeat=2 -> 16 kv heads aligned to TP16."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=12288, vocab_size=151936,
        qk_norm=True, rope_theta=1e6, kv_repeat=2,
        parallelism="fsdp",
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, kv_repeat=1,
    )
