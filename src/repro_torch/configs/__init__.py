"""Architecture registry: ``--arch <id>`` → ModelConfig (the port's own
copy of ``repro.configs``, every ``config()`` and ``smoke_config()`` the
same).

Ten assigned architectures plus the paper's own workload (``edm_ccm``).
Every entry exposes ``config()`` (full, dry-run only) and
``smoke_config()`` (reduced, runs on one CPU device).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    MambaConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SHAPES,
    TrainConfig,
    XLSTMConfig,
)

ARCHS = (
    "qwen1.5-4b",
    "llama3-8b",
    "yi-6b",
    "nemotron-4-15b",
    "jamba-v0.1-52b",
    "hubert-xlarge",
    "llava-next-mistral-7b",
    "xlstm-125m",
    "llama4-maverick-400b-a17b",
    "deepseek-v2-lite-16b",
)

# Shape-cell applicability (DESIGN.md §5): encoder-only archs have no
# decode step; long_500k needs sub-quadratic decode.
SKIP_CELLS = {
    "hubert-xlarge": {"decode_32k", "long_500k"},
    "qwen1.5-4b": {"long_500k"},
    "llama3-8b": {"long_500k"},
    "yi-6b": {"long_500k"},
    "nemotron-4-15b": {"long_500k"},
    "llava-next-mistral-7b": {"long_500k"},
    "llama4-maverick-400b-a17b": {"long_500k"},
    "deepseek-v2-lite-16b": {"long_500k"},
}


def _module(arch: str):
    mod = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    m = _module(arch)
    return m.smoke_config() if smoke else m.config()


def cells(arch: str) -> list[str]:
    """Applicable shape-cell names for an architecture."""
    skip = SKIP_CELLS.get(arch, set())
    return [s for s in SHAPES if s not in skip]


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in cells(a)]
