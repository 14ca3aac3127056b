"""llama4-maverick-400b-a17b — MoE decoder, 128 experts top-1, alternating
dense/MoE layers, early-fusion multimodal (frontend stubbed out of scope).
[hf:meta-llama/Llama-4-Scout-17B-16E (family); assignment sheet]

48L, d_model 5120, 40 heads (kv=8), expert d_ff 8192 (dense layers use
2×8192), vocab 202048. ~400B total / ~17B active params. Params are kept
in bf16 with the 8-bit block-quantized Adam (repro.optim) so the training
state fits 16 GB/chip on the single-pod mesh (DESIGN.md §4).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=16384, vocab_size=202048, rope_theta=500_000.0,
        pattern=("attn_moe", "attn"),
        moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                      num_shared=1),
        param_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=128, pattern=("attn_moe", "attn"),
        moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=128,
                      num_shared=1),
        dtype="float32", param_dtype="float32",
    )
