"""Losses and metrics of the port: the SCE loss (``sce.py``) and the dense
evaluation oracle (``metrics.py``)."""
