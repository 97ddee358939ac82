"""Attention math (plain PyTorch) and the fused encoder kernel's wrapper."""
