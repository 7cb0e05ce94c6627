"""Alias of sample/generate.py (port of sample/sample_fullseq.py)."""
from .generate import main  # noqa: F401

if __name__ == "__main__":
    main()
