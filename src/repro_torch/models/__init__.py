"""Models of the port: the recsys family (``recsys``, DCN-v2), the LM
transformer (``transformer``, GQA) and the shared layers they need
(``layers``)."""
