"""Kernels of the port: plain PyTorch versions (``ref``), hand-written
CUDA kernels (``csrc/`` with their wrappers), and the dispatch seam
(``ops``) that picks between them by the tensors' device."""
