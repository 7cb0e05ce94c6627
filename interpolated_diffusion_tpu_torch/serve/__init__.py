"""Serving layer (port of serve/): `GenerationService` runs the maze
pipeline behind bucketed batch shapes, and `serve.server` exposes it over
HTTP with a linger-based request batcher so concurrent clients share one
pipeline call."""
from .service import GenerationService  # noqa: F401
