"""End-to-end samplers."""
