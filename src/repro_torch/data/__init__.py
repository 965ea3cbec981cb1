"""Host-side data for the port (numpy, no torch on the hot path)."""
