"""qwen1.5-4b — dense GQA decoder with QKV bias. [hf:Qwen/Qwen1.5-4B; hf]

40L, d_model 2560, 20 heads (kv=20 → MHA), d_ff 6912, vocab 151936,
rope_theta 5e6, SwiGLU. Note: 20 heads do not divide the 16-way model
axis; sharding falls back to flattened-projection sharding (DESIGN.md §4).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
        d_ff=6912, vocab_size=151936, qkv_bias=True,
        rope_theta=5_000_000.0, pattern=("attn",),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=128, qkv_bias=True, pattern=("attn",),
        dtype="float32", param_dtype="float32",
    )
