"""Kernels of the port (flash and decode attention, RMSNorm): CUDA C++ sources
in ``csrc/``, their ctypes wrappers, the plain PyTorch versions (``ref``) and
the dispatch (``ops``)."""
