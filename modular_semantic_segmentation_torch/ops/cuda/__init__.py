"""Wrappers of the hand-written CUDA kernels in ``csrc/``.

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version of the same function, in the same module, for CPU tensors.
"""
