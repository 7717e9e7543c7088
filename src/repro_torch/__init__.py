"""PyTorch/CUDA port of the ByteScale reproduction.

A package of its own beside the JAX reference (`repro`): it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Pure-Python
modules it needs (configs, the HDP planner, the scheduler service,
observability) are kept here as copies under the same relative paths.
Prefill attention on a CUDA device runs the hand-written Hopper kernel in
``kernels/csrc/flash_fwd.cu``; on the CPU it runs that kernel's plain
PyTorch version.
"""
