"""LM substrate of the port: the model zoo of ``repro.models`` in eager
PyTorch (``init_params`` returns an ``nn.Module`` of the reference's
parameter tree; the layers are plain functions on tensors)."""

from repro_torch.models.transformer import (
    abstract_params,
    decode_step,
    forward_train,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)

__all__ = [
    "abstract_params",
    "decode_step",
    "forward_train",
    "init_cache",
    "init_params",
    "loss_fn",
    "prefill",
]
