"""Alias of train/train_interp_levels_causal.py (port of train/train_causal.py)."""
from .train_interp_levels_causal import main  # noqa: F401

if __name__ == "__main__":
    main()
