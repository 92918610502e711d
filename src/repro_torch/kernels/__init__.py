"""Streaming kernels of the port: hand-written CUDA C++ for Hopper (csrc/),
their ctypes wrappers with plain PyTorch versions beside them, and the ops
layer (ops.py) that the engine calls."""
