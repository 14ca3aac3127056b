"""yi-6b — llama-architecture GQA decoder. [arXiv:2403.04652; hf]

32L, d_model 4096, 32 heads (kv=4), d_ff 11008, vocab 64000,
rope_theta 5e6, SwiGLU.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab_size=64000, rope_theta=5_000_000.0,
        pattern=("attn",),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab_size=128, pattern=("attn",),
        dtype="float32", param_dtype="float32",
    )
