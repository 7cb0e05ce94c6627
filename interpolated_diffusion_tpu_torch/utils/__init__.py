"""Video token and per-frame feature helpers."""
