"""Host-side datasets and loaders of the port (numpy only)."""
