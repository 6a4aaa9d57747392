"""The fourteen kernels: CUDA sources (`csrc/`), plain PyTorch versions,
the dispatch (`ops`) and the build (`_build`)."""
