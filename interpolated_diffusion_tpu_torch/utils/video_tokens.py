"""Latent <-> token conversion for video models (port of utils/video_tokens.py).

[B, T, C, H, W] latents <-> [B, T, N, D] per-frame tokens with
N = (H/p)(W/p) and D = C*p^2, in the JAX package's element order.
"""
from __future__ import annotations

from typing import Tuple

import torch


def patchify_latents(latents: torch.Tensor, patch_size: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    if latents.ndim != 5:
        raise ValueError("latents must have shape [B,T,C,H,W]")
    B, T, C, H, W = latents.shape
    if H % patch_size or W % patch_size:
        raise ValueError("latent H/W must be divisible by patch_size")
    H_p, W_p = H // patch_size, W // patch_size
    z = latents.reshape(B, T, C, H_p, patch_size, W_p, patch_size)
    z = z.permute(0, 1, 3, 5, 2, 4, 6)
    return z.reshape(B, T, H_p * W_p, C * patch_size * patch_size), (H_p, W_p)


def unpatchify_tokens(tokens: torch.Tensor, patch_size: int,
                      spatial_shape: Tuple[int, int]) -> torch.Tensor:
    if tokens.ndim != 4:
        raise ValueError("tokens must have shape [B,T,N,D]")
    B, T, N, D = tokens.shape
    H_p, W_p = spatial_shape
    if N != H_p * W_p:
        raise ValueError("spatial_shape does not match token count")
    if D % (patch_size * patch_size):
        raise ValueError("token dim must be divisible by patch_size**2")
    C = D // (patch_size * patch_size)
    z = tokens.reshape(B, T, H_p, W_p, C, patch_size, patch_size)
    z = z.permute(0, 1, 4, 2, 5, 3, 6)
    return z.reshape(B, T, C, H_p * patch_size, W_p * patch_size)
