"""Models of the port: SASRec, BERT4Rec, the transformer LMs and their MoE
FFN, the CTR models (``recsys.py``), SchNet, their layers and the
weight converter from the JAX package (``convert.py``)."""
