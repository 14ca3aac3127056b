"""Launchers of the port: the serve and train CLIs (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``), and
the LM substrate's meshes (``mesh``) and sharding rules (``sharding``)."""

from repro_torch.launch import mesh, sharding

__all__ = ["mesh", "sharding"]
