"""llama3-8b — dense GQA decoder, 128k vocab. [arXiv:2407.21783]

32L, d_model 4096, 32 heads (kv=8), d_ff 14336, vocab 128256,
rope_theta 5e5, SwiGLU.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256, rope_theta=500_000.0,
        pattern=("attn",),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=128, pattern=("attn",),
        dtype="float32", param_dtype="float32",
    )
