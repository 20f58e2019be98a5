"""Tensor operations of the port. Modules are imported by name; nothing
here imports the CUDA bindings in ``kernels/``."""
