"""Emerald on PyTorch: the port of ``repro`` to PyTorch and CUDA on an
NVIDIA H100. It imports torch, numpy and the standard library only."""
