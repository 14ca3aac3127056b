"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

A second package beside the JAX reference: the module layout mirrors
``repro`` so each module's counterpart is found under the same path, and
every Pallas kernel of a ported path has a hand-written CUDA kernel under
``kernels/csrc/``. The package imports torch, numpy and the standard
library only — never ``jax`` and never ``repro``.

Entry point: ``from repro_torch.edm import EDM`` — ``EDM(panel)`` binds a
panel on the GPU (``EDMConfig(device="cuda")`` is the default; a session
raises when CUDA is absent instead of falling back to the CPU), then
``optimal_E()`` and ``xmap()`` run kEDM's headline workload, and
``ccm(lib, target, lib_sizes=...)`` / ``surrogate_test(lib, target)``
test one link for convergence and significance.
"""
