"""longtr_tpu_torch — the LongTR-TPU genotyper on PyTorch and CUDA.

The same `longtr` genotyping path as :mod:`longtr_tpu`, with the device
work in PyTorch and the mode-A pair-HMM in two CUDA kernels written for
Hopper (``csrc/pairhmm.cu``).  The host layers (I/O, haplotype
generation, the native C++ library, stutter models, filters, phasing,
left-alignment, the console tools) are this package's own copies of the
JAX package's, so nothing here imports :mod:`longtr_tpu`.

The package imports ``torch`` and never ``jax``.
"""

from longtr_tpu_torch.version import __version__

__all__ = ["__version__"]
