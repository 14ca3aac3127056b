"""Launchers of the port: the serve and train CLIs (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``)."""
