"""Config dataclasses for the architecture zoo (the port's own copy of
``repro.configs.base``: every class, field and default is the same).

One ``ModelConfig`` describes any of the 10 assigned architectures (plus
reduced smoke variants). Layer heterogeneity (hybrid/MoE interleaves) is
expressed as a repeating ``pattern`` of block kinds; the stack scans over
pattern repeats so HLO size stays O(pattern), not O(n_layers).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0  # always-on experts (DeepSeek-style)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 → ceil(d_model / 16)
    chunk: int = 128  # scan chunk (memory/recompute tradeoff)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor_m: float = 2.0  # mLSTM block up-projection
    proj_factor_s: float = 4.0 / 3.0  # sLSTM post-FFN factor
    chunk: int = 64  # mLSTM chunked-parallel length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 → d_model // n_heads

    # Block pattern: tuple of kinds, cycled to n_layers. Kinds:
    #   "attn"   – attention + dense MLP
    #   "attn_moe" – attention + MoE
    #   "mamba" / "mamba_moe" – Mamba mixer + dense/MoE MLP-free block
    #   "mlstm" / "slstm"      – xLSTM blocks
    pattern: tuple[str, ...] = ("attn",)

    attention: str = "gqa"  # gqa | mla
    causal: bool = True
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mlp: str = "swiglu"  # swiglu | relu2
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # Modality stub: inputs are precomputed (B, S, d_model) embeddings
    # (audio frames / vision patches) instead of token ids.
    embed_inputs: bool = False

    # MLA (DeepSeek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # numerics / compile strategy
    dtype: str = "bfloat16"  # activations/params compute dtype
    param_dtype: str = "float32"  # master params
    remat: bool = True
    scan_layers: bool = True
    attn_chunk_q: int = 512  # chunked attention for long prefill
    attn_full_max: int = 1024  # full S×S attention at or below this

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"pattern length {len(self.pattern)}"
            )

    @property
    def n_units(self) -> int:
        """Number of scanned pattern repeats."""
        return self.n_layers // len(self.pattern)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba.expand * self.d_model

    @property
    def mamba_dt_rank(self) -> int:
        r = self.mamba.dt_rank
        return r if r else math.ceil(self.d_model / 16)

    def param_count(self) -> int:
        """Analytic parameter count (drives 6ND roofline numbers)."""
        from repro_torch.models.transformer import abstract_params  # lazy

        return sum(p.numel() for p in abstract_params(self).parameters())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared of routed ffn)."""
        total = self.param_count()
        if self.moe is None:
            return total
        moe_layers = sum(k.endswith("_moe") for k in self.pattern) * self.n_units
        per_expert = 3 * self.d_model * self.moe.d_ff_expert
        inactive = (
            moe_layers
            * (self.moe.num_experts - self.moe.top_k)
            * per_expert
        )
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    optimizer: str = "adamw"  # adamw | adamw8bit
    microbatch: int = 0  # 0 → no gradient accumulation
    seed: int = 0
    # distributed-optimization knobs
    grad_compression: str = "none"  # none | bf16 | int8
    zloss: float = 0.0
