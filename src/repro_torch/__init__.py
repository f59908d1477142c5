"""PyTorch/CUDA port of the Continuum serving stack.

Mirrors ``src/repro`` module for module: the pure-Python control plane is
carried as a copy (``core/``, ``serving/``, ``sim/``, ``configs/``), the
model and the paged KV runtime are rewritten in PyTorch, and every Pallas
TPU kernel on the serving path is a hand-written CUDA kernel for Hopper
(``csrc/``). Entry points run on the GPU unless the caller passes
``device="cpu"``, which takes the plain PyTorch versions of the kernels.
"""
