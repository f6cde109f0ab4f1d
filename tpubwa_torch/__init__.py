"""tpubwa_torch — tpubwa's BWA-MEM aligner on PyTorch and CUDA.

The port of tpubwa (JAX on a TPU) to one NVIDIA Hopper GPU.  It keeps
its own copy of tpubwa's JAX-free host code (index, io, ref, native
seeding/planning/emit, host pipeline, SAM, sim) and replaces the device
side: the banded Smith-Waterman seed extension is a hand-written CUDA
kernel (csrc/extend.cu) with a plain PyTorch version beside it.  Nothing
here imports JAX or any module of the ``tpubwa`` package.
"""

__version__ = "0.1.0"

from .opts import MemOpt

__all__ = ["MemOpt", "__version__"]
