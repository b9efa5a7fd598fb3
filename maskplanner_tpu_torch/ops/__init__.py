"""Geometric ops of the port; a CUDA tensor reaches a kernel of ``cuda/``,
a CPU tensor its plain PyTorch version."""
