"""Diagnostics of the port (port of the JAX package's diagnostics/)."""
