"""Host-side utilities of the port (synthetic inputs)."""
