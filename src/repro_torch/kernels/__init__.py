"""The fifteen kernels (the fourteen TPU kernels and the hash reduce's
chained probe): CUDA sources (`csrc/`), plain PyTorch versions, the
dispatch (`ops`) and the build (`_build`)."""
