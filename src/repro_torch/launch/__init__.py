"""Step builders of the port (``steps``)."""
