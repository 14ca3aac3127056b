"""llava-next-mistral-7b — VLM with Mistral-7B text backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

32L, d_model 4096, 32 heads (kv=8), d_ff 14336, vocab 32000. The anyres
vision tower + projector is a STUB: input_specs() provides precomputed
(B, S, 4096) patch+text embeddings for train/prefill; decode consumes
text token ids (the 32k-vocab embedding table exists for generation).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000, rope_theta=1_000_000.0,
        embed_inputs=True, pattern=("attn",),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=64, embed_inputs=True, pattern=("attn",),
        dtype="float32", param_dtype="float32",
    )
