"""Attention kernels of the port: CUDA C++ sources in ``csrc/``, their ctypes
wrappers, the plain PyTorch versions (``ref``) and the dispatch (``ops``)."""
