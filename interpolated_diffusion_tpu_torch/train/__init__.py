"""Batch helpers shared by sampling and (later) training."""
