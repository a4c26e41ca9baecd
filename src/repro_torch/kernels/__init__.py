"""Kernels: the hand-written CUDA kernels, their plain PyTorch versions, and
the wrappers that pick between them by the device of their inputs."""
