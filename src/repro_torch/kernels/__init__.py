"""Kernels of the port: flash and decode attention and RMSNorm (the JAX
package's Pallas kernels), window scoring and the z fold (its detection jit
kernels), water-filling and the EWMA scan (its other simulator jit
kernels). CUDA C++ sources in ``csrc/``, their ctypes wrappers, the plain
PyTorch versions (``ref``; ``detect_ref`` for detection and the scan;
``waterfill.waterfill_ref`` beside its wrapper), the wrappers' shared
checks (``checks``) and the dispatch (``ops``)."""
