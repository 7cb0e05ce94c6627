"""Hand-written Hopper kernels with their plain PyTorch twins.

Each public wrapper runs its plain twin for CPU tensors and launches its
CUDA kernel for CUDA tensors; `wrapper.launches` counts kernel launches.
"""
