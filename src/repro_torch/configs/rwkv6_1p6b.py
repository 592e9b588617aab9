"""rwkv6-1.6b [ssm] — Finch: 24L d2048 (attention-free) d_ff=7168
vocab=65536, data-dependent decay [arXiv:2404.05892]. O(1) decode state."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="rwkv6",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=7168, vocab_size=65536,
        rwkv_head_dim=64, rwkv_lora_rank=32, wkv_chunk=16,
        parallelism="fsdp",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, rwkv_head_dim=16, rwkv_lora_rank=4,
        wkv_chunk=4,
    )
