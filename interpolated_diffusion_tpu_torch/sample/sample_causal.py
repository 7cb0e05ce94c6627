"""Alias of sample/generate_causal.py (port of sample/sample_causal.py)."""
from .generate_causal import main  # noqa: F401

if __name__ == "__main__":
    main()
