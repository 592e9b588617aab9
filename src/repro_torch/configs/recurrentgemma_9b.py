"""recurrentgemma-9b [hybrid] — 38L d4096 16H (MQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention 2:1 [arXiv:2402.19427]. Pattern
(rec, rec, attn_local) with window 2048; O(1)+window decode state.
kv_repeat=16 replicates the MQA head across TP16."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="griffin",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        head_dim=256, d_ff=12288, vocab_size=256000,
        pattern=("rec", "rec", "attn_local"), window_size=2048,
        lru_width=4096, conv_width=4, kv_repeat=16,
        parallelism="fsdp",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=256, lru_width=64,
        window_size=8, kv_repeat=4,
    )
