"""Kernels of the port: flash and decode attention and RMSNorm (the JAX
package's Pallas kernels), window scoring and the z fold (its detection jit
kernels). CUDA C++ sources in ``csrc/``, their ctypes wrappers, the plain
PyTorch versions (``ref``; ``detect_ref`` for detection), the detection
wrappers' shared checks (``checks``) and the dispatch (``ops``)."""
