"""command-r-35b [dense] — 40L d8192 64H (GQA kv=8) d_ff=22528 vocab=256000,
no-bias [hf:CohereForAI/c4ai-command-r-v01]. kv_repeat=2 aligns 16 kv heads
to 16-way TP (vLLM-style replication)."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=22528, vocab_size=256000,
        rope_theta=8e6, kv_repeat=2,
        fsdp=True, parallelism="fsdp",
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=8, d_ff=128, vocab_size=256, kv_repeat=2,
    )
