"""Models of the port: SASRec (``sasrec.py``), its layers and the
weight converter from the JAX package (``convert.py``)."""
