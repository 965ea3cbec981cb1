"""Models of the port: the recsys family (``recsys``, DCN-v2) and the
shared layers it needs (``layers``)."""
