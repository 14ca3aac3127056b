"""deepseek-v2-lite-16b — MLA attention + fine-grained MoE.
[arXiv:2405.04434; hf]

27L, d_model 2048, 16 heads, MLA kv_lora_rank 512 (qk_nope 128, qk_rope
64, v 128), vocab 102400. Per the assignment sheet: uniform MoE, 64
routed experts top-6 + 2 shared, expert d_ff 1408. (Deviations from the
HF reference, recorded in DESIGN.md: the reference's layer 0 is a dense
d_ff=10944 MLP — the assignment specifies uniform MoE, which also lets
the 27 layers scan (unrolling kept ~90 dispatch buffers live → 36 GB/
device); the sheet's "160 routed" is DeepSeek-V2-full, -Lite has 64.)
"""

from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102400, pattern=("attn_moe",),
        attention="mla", kv_lora_rank=512, qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128,
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                      num_shared=2),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=128, pattern=("attn", "attn_moe", "attn_moe"),
        attention="mla", kv_lora_rank=32, qk_nope_dim=16,
        qk_rope_dim=8, v_head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64, num_shared=1),
        dtype="float32", param_dtype="float32",
    )
