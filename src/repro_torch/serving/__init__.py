"""LM serving of the port: the continuous-batching engine."""
