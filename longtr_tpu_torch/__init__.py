"""longtr_tpu_torch — the LongTR-TPU genotyper on PyTorch and CUDA.

The same `longtr` genotyping path as :mod:`longtr_tpu`, with the device
work in PyTorch and the mode-A pair-HMM in two CUDA kernels written for
Hopper (``csrc/pairhmm.cu``).  Host layers that never import JAX (I/O,
haplotype generation, the native C++ library, stutter models, filters,
phasing, left-alignment) are imported from :mod:`longtr_tpu` unchanged;
this package owns the modules that the JAX package ties to JAX.

The package imports ``torch`` and never ``jax``.
"""

from longtr_tpu.version import __version__

__all__ = ["__version__"]
