"""qwen3-14b [dense] — 40L d5120 40H (GQA kv=8) d_ff=17408 vocab=151936,
qk_norm [hf:Qwen/Qwen3-*]. 40 heads over 16-way TP is non-divisible
(GSPMD pads; see §Perf notes); GQA group 5 admits no aligning kv_repeat."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=17408, vocab_size=151936,
        qk_norm=True, rope_theta=1e6, kv_repeat=1,
        parallelism="fsdp",
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
    )
