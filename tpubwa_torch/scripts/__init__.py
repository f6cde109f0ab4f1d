"""Ported experiment entry points: the counterparts of tpubwa's
``scripts/`` that run a TPU kernel, each with its kernel as hand-written
CUDA.  Run one with ``python -m tpubwa_torch.scripts.<name>``."""
