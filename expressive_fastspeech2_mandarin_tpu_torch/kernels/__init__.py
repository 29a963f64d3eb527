"""Build and load the CUDA sources in ``csrc/``."""
