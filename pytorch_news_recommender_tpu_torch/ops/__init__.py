"""Attention math (plain PyTorch) and the fused encoder kernels' wrappers."""
