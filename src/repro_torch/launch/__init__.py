"""Entry points of the port: step factories and the retrieval server."""
