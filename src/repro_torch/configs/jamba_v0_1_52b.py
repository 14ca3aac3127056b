"""jamba-v0.1-52b — hybrid Mamba+attention (1:7) with MoE (16e top-2).
[arXiv:2403.19887; hf]

32L, d_model 4096, 32 heads (kv=8) in the attention layers, d_ff 14336,
vocab 65536. Pattern per Jamba block (8 layers): attention at index 4,
MoE every other layer; 4 blocks scanned. Runs the long_500k cell
(sub-quadratic decode: 28/32 layers are O(1)-state Mamba).
"""

from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

_PATTERN = ("mamba", "mamba_moe", "mamba", "mamba_moe",
            "attn", "mamba_moe", "mamba", "mamba_moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=65536, pattern=_PATTERN,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
        mamba=MambaConfig(),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=128, pattern=_PATTERN,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        mamba=MambaConfig(d_state=4, d_conv=2, chunk=16),
        dtype="float32", param_dtype="float32",
    )
