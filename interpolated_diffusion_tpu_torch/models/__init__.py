"""Denoisers, condition encoders and the FiLM transformer (torch nn.Modules)."""
