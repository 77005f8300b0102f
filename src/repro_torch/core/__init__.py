"""Losses of the port: the SCE loss (``sce.py``)."""
