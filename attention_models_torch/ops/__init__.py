"""Kernel wrappers of the PyTorch/CUDA port (see ops/dispatch.py)."""
