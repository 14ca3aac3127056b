"""nemotron-4-15b — dense GQA decoder with squared-ReLU MLP.
[arXiv:2402.16819]

32L, d_model 6144, 48 heads (kv=8), d_ff 24576, vocab 256000, ReLU².
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab_size=256000, mlp="relu2",
        rope_theta=10_000.0, pattern=("attn",),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=128, mlp="relu2", pattern=("attn",),
        dtype="float32", param_dtype="float32",
    )
