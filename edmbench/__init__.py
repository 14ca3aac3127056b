"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

Driven by ``BENCHMARK.json`` at the repository's root; ``run.py`` is its
command line, ``harness.run`` one run of one cell. See ``spec`` for how a
cell's parts are found by name.
"""
