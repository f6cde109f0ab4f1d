"""Device side of tpubwa_torch: index state, tile gathers and the CUDA
seed-extension kernel, each with a plain PyTorch version for the CPU."""
