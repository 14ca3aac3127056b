"""Optimizer substrate of the port: AdamW (float32 + 8-bit block-quantized
moments), schedules, clipping, microbatch accumulation — plain eager
PyTorch, in place (``repro_torch.optim.adamw``)."""

from repro_torch.optim.adamw import adamw_init, adamw_update, make_optimizer
from repro_torch.optim.grad_utils import (
    accumulate_microbatches,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = [
    "adamw_init", "adamw_update", "make_optimizer",
    "accumulate_microbatches", "clip_by_global_norm", "global_norm",
    "constant", "warmup_cosine",
]
