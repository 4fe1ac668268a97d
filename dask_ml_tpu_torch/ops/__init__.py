"""Distance kernels and their plain PyTorch versions."""
