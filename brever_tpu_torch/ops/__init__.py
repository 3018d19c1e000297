"""Tensor ops of the port: each kernel module holds the hand-written
CUDA wrapper and its plain PyTorch version."""
