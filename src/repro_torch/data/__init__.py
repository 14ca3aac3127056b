"""Synthetic dynamical systems (numpy only), copied from ``repro.data``."""

from repro_torch.data.timeseries import (
    coupled_logistic,
    forced_network_panel,
    logistic_map,
    lorenz63,
    tent_map_panel,
)

__all__ = [
    "coupled_logistic",
    "forced_network_panel",
    "logistic_map",
    "lorenz63",
    "tent_map_panel",
]
