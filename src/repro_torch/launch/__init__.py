"""Launchers of the port: the serve CLI (``python -m
repro_torch.launch.serve``)."""
