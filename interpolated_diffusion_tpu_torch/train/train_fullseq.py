"""Alias of train/train_interp_levels.py (port of train/train_fullseq.py)."""
from .train_interp_levels import main  # noqa: F401

if __name__ == "__main__":
    main()
