"""xlstm-125m — sLSTM + mLSTM recurrent LM. [arXiv:2405.04517]

12L, d_model 768, 4 heads, vocab 50304, no separate FFN (d_ff=0; the
xLSTM blocks carry their own up/down projections). Block ratio ≈ the
paper's xLSTM[7:1]: one sLSTM block (index 6) among 11 mLSTM blocks.
Runs long_500k (O(1)-state recurrent decode); sLSTM is strictly
sequential (lax.scan) — the paper's own parallelization caveat.
"""

from repro_torch.configs.base import ModelConfig, XLSTMConfig

_PATTERN = ("mlstm",) * 6 + ("slstm",) + ("mlstm",) * 5


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304, pattern=_PATTERN,
        xlstm=XLSTMConfig(),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=128, pattern=("mlstm", "slstm", "mlstm"),
        xlstm=XLSTMConfig(chunk=16),
        dtype="float32", param_dtype="float32",
    )
