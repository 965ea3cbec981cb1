"""The port's roofline: the H100 bound model and a cost model that
counts a program's work as it runs (``roofline.analysis``)."""
