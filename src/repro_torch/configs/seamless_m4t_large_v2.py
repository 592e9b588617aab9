"""seamless-m4t-large-v2 [audio] — enc-dec backbone: 24L encoder + 24L
decoder, d1024 16H (kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596];
padded to 256208 (next multiple of 16) so the vocab-parallel lm_head and
embedding shard evenly on 16-way TP — standard Megatron-style vocab padding
(the 2 pad rows are never produced by the tokenizer stub).
The speech frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S_frames, d)."""
import dataclasses
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
        num_kv_heads=16, head_dim=64, d_ff=8192, vocab_size=256208,
        cross_attention=True, frontend="audio",
        parallelism="fsdp",
        skip_shapes=("long_500k",),
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
    )
