"""Evaluation of sampled trajectories."""
