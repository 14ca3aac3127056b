"""hubert-xlarge — encoder-only audio transformer backbone.
[arXiv:2106.07447]

48L, d_model 1280, 16 heads (kv=16), d_ff 5120, 504 masked-prediction
classes, GELU MLP, bidirectional. The conv waveform frontend is a STUB:
input_specs() provides precomputed (B, S, 1280) frame embeddings.
Encoder-only → decode_32k / long_500k cells are skipped (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab_size=504, mlp="gelu", causal=False,
        embed_inputs=True, pattern=("attn",),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=32, mlp="gelu", causal=False,
        embed_inputs=True, pattern=("attn",),
        dtype="float32", param_dtype="float32",
    )
