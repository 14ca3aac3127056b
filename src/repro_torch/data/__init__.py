"""Synthetic dynamical systems (numpy only), copied from ``repro.data``,
and one panel of the port's own for the append kernel's root rule."""

from repro_torch.data.timeseries import (
    coupled_logistic,
    forced_network_panel,
    logistic_map,
    lorenz63,
    root_collision_panel,
    tent_map_panel,
)

__all__ = [
    "coupled_logistic",
    "forced_network_panel",
    "logistic_map",
    "lorenz63",
    "root_collision_panel",
    "tent_map_panel",
]
