"""Diffusion schedules, DDIM, keyframe masks, interpolation and clamping."""
