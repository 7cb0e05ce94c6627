"""PyTorch + CUDA port of interpolated_diffusion_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (ops/, models/, kernels/, sample/, train/,
utils/). The Pallas kernels on the ported paths (maze sampling; Wan2.1
Phase-1 anchor sampling) are hand-written sm_90a CUDA kernels under csrc/,
built with nvcc at first use (kernels/_build.py). Importing this package
imports neither JAX nor the CUDA library.
"""
