"""PyTorch/CUDA port of the gradient-output-sparsity system (``repro``).

Laid out module for module like the JAX package ``repro``, which stays the
reference: ``kernels/`` holds the hand-written Hopper kernels (CUDA C++ in
``csrc/``, built with nvcc at first use) with a plain PyTorch version beside
each, ``core/`` the sparse conv/linear units and the policy, ``models/`` the
CNNs, ``data/`` the synthetic batches.  Public functions keep the JAX
layouts (NHWC activations, HWIO weights, ``(T, K) @ (K, N)`` GEMMs).

The port never imports ``jax`` or ``repro``.  Kernels run only on a CUDA
device; a wrapper handed a CPU tensor runs its plain version instead.
"""
from .device import resolve_device  # noqa: F401
