"""The detection kernels' plain PyTorch versions, under the reference's path.

Counterpart of ``repro.core.jaxsim.kernels``. The functions live in the
kernel package (``repro_torch.kernels.detect_ref``), beside the CUDA
kernels' wrappers that compute them on CPU tensors; this module re-exports
them so that each has its counterpart where the JAX package keeps it.
"""
from repro_torch.kernels.detect_ref import (PAD_KEY, fused_window_kernel,  # noqa: F401
                                            grouped_median_kernel, padded_rows, row_median,
                                            slow_fold_kernel)
